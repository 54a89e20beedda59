"""Seconds the engine's build spent pinning the remote tiers: the pinned
allocations, zero-fills and copies of the remote weight tiers and KV pools
(`dak.pin` in the newest build record; program span)."""
from bench import spans

LAYER, UNIT, SOURCE, MOVES, BETTER = "host link", "s", "program_span", "setup_s", "lower"


def read(r):
    build = spans.build()
    return build.seconds.get("dak.pin") if build is not None else None
