"""The LM training loop of the port."""
