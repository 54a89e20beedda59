"""Fault tolerance + distributed-optimization helpers (the reference's
`distributed/`, over torch.distributed)."""
