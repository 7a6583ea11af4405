"""Serving layer of the port: paged engine, page pool, mux server."""
