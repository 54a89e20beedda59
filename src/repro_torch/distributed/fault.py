"""Fault tolerance: restart loops, straggler detection, elastic policy.

On a real multi-host pod these hooks wire to the cluster scheduler; in this
repo they are exercised by fault-injection tests and by launch/train.py.

* ``RestartLoop`` — wraps the training loop; on failure restores the latest
  checkpoint and resumes (bounded restarts, exponential backoff).
* ``StragglerDetector`` — EMA step-time monitor; flags steps slower than
  ``threshold ×`` the running median (the elastic policy downsizes the mesh
  when a straggling host persists).
* ``ElasticPlan`` — given surviving host count, picks the largest legal mesh
  and the checkpoint re-shard target (restore is mesh-agnostic because
  checkpoints store full logical arrays — see checkpoint/manager.py).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable


@dataclasses.dataclass
class StragglerDetector:
    threshold: float = 2.5          # step slower than 2.5x median => straggler
    window: int = 32
    _times: deque = dataclasses.field(default_factory=lambda: deque(maxlen=32))
    flagged: int = 0

    def observe(self, step_seconds: float) -> bool:
        self._times.append(step_seconds)
        if len(self._times) < 8:
            return False
        med = sorted(self._times)[len(self._times) // 2]
        if step_seconds > self.threshold * med:
            self.flagged += 1
            return True
        return False


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    """Mesh downsizing policy: keep the model axis, shrink data parallelism."""

    data: int
    model: int

    @staticmethod
    def for_devices(n_devices: int, model_axis: int) -> "ElasticPlan":
        data = max(1, n_devices // model_axis)
        # largest power-of-two data axis that fits (keeps batch divisible)
        p = 1
        while p * 2 <= data:
            p *= 2
        return ElasticPlan(data=p, model=model_axis)


class FaultInjector:
    """Deterministic fault injection for tests: raise at given steps."""

    def __init__(self, fail_at: set[int] | None = None):
        self.fail_at = fail_at or set()
        self.raised: set[int] = set()

    def maybe_fail(self, step: int) -> None:
        if step in self.fail_at and step not in self.raised:
            self.raised.add(step)
            raise RuntimeError(f"injected node failure at step {step}")


@dataclasses.dataclass
class RestartLoop:
    """Run `body(start_step) -> final_step`, restarting on failure."""

    max_restarts: int = 3
    backoff_s: float = 0.0
    restarts: int = 0

    def run(self, body: Callable[[int], int], start_step: int = 0,
            on_restart: Callable[[], int] | None = None) -> int:
        step = start_step
        while True:
            try:
                return body(step)
            except Exception as e:  # noqa: BLE001 — any failure is restartable
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise RuntimeError(
                        f"exceeded {self.max_restarts} restarts") from e
                if self.backoff_s:
                    time.sleep(self.backoff_s * (2 ** (self.restarts - 1)))
                step = on_restart() if on_restart is not None else start_step
