"""Synthetic datasets of the port (no download)."""
