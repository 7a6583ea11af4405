"""The multiplexer and model-level routing of the port."""
