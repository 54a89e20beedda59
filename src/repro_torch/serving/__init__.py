"""Serving: the paged tiered KV cache, the tiered decode step and the engine."""
