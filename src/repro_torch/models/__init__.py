"""Model stack of the port (dense self-attention decoders)."""
