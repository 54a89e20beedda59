"""Serving frontend: clocks, request records and schedulers."""
