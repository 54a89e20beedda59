"""The program's phase ledger (`repro_torch.obs.trace.PhaseLedger`) as the
readers see it: the step records of the window, and the engine's build
record.  The ledger holds plain numbers, filled by the engine's `dak.*`
regions.  The window is exactly the last ``len(r.steps)`` steps of the
newest ledger: the harness runs no step between the window and its
readers.  A program without the ledger gives None, so each reader finds
nothing to read."""
from __future__ import annotations


def _ledger():
    try:
        from repro_torch.obs import trace
    except ImportError:
        return None
    latest = getattr(trace, "latest_ledger", None)
    return latest() if latest is not None else None


def window(r) -> list | None:
    """The step records of the window, oldest first (None without them)."""
    ledger = _ledger()
    return ledger.window(len(r.steps)) if ledger is not None else None


def build():
    """The build record of the newest engine (None without it)."""
    ledger = _ledger()
    return ledger.build if ledger is not None else None
