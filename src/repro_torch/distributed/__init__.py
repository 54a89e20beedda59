"""Distributed-optimization collectives over torch.distributed (the
reference's `distributed/`; its fault tolerance waits for the training stack).
"""
