"""Observability of the port (the null tracer so far)."""
