"""The direct-access entry points, marked for the materialization lint.

The lint (`analysis.materialization`) follows remote-tier data through
the aten ops a step runs and must treat each direct-access entry point as
one opaque consumer, as the reference's lint treats ``pallas_call``: a
kernel reads the remote tier in place (or, for `ops.gather_shards`, moves
each shard up its own host link once), so what it returns holds no copy
of remote data, whatever its plain version does to compute the same
values.  :func:`direct_access` marks such an entry point.  Outside a lint
the marked function costs one check of a module global and runs as it
was: no launch and no captured graph changes.  While a lint runs,
`_hook` is the lint's handler, which runs the entry with the lint
suspended and returns its outputs clean; on the meta device, where no
kernel runs, it runs the entry's ``plain`` version (the same arguments,
the same outputs) for their shapes.

``SINKS`` lists the marked entry points by name.
"""
from __future__ import annotations

import functools
from typing import Any, Callable

# The active lint's handler, ``hook(entry, plain, args, kwargs)``, or None.
_hook: Callable[..., Any] | None = None

SINKS: dict[str, Callable[..., Any]] = {}


def direct_access(plain: Callable[..., Any]) -> Callable[[Callable[..., Any]], Callable[..., Any]]:
    """Mark a direct-access entry point; ``plain`` takes its arguments and
    returns what it returns (or writes what it writes), in plain PyTorch."""
    def mark(fn: Callable[..., Any]) -> Callable[..., Any]:
        @functools.wraps(fn)
        def entry(*args, **kwargs):
            if _hook is None:
                return fn(*args, **kwargs)
            return _hook(fn, plain, args, kwargs)

        SINKS[fn.__name__] = entry
        return entry

    return mark
