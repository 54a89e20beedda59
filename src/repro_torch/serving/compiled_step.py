"""The compiled decode step: one CUDA graph per shape bucket.

Counterpart of the reference's jitted decode step
(``src/repro/serving/engine.py`` ``_compiled_step``, one donated
``jax.jit`` per (kind, window bucket, pool shape)).  The serving engine
keeps one :class:`StepGraph` per bucket; the first step of a bucket runs
eagerly on a side stream (the warm-up, whose tokens are that step's
tokens) and is then captured, and every later step of the bucket replays
the graph: one launch of the whole step instead of one Python call per
kernel and per small op.

* :class:`StepInputs` holds fixed device buffers for a step's int32
  inputs (tokens ``[B,1]``, positions, attention lengths, the page table
  and its tiers ``[B, MP]``, the write targets).  Each step's values go
  into one pinned staging buffer and reach the fixed buffers by one
  ``non_blocking`` copy; the graphed and the eager step both read them.
  :meth:`StepInputs.fetch` brings the step's ``[B]`` tokens back through
  one ``non_blocking`` copy into pinned memory and an event wait: the
  step's only host sync.
* A graph fixes every address it was captured with: the params' tiers,
  the page pools, the sinks, the recurrent state and the fixed buffers.
  The engine drops its graphs when any of those move (a re-plan that
  moves weights, a grown remote pool); a dropped graph is captured again
  the next time its bucket runs.  Greedy ``argmax`` runs inside the
  graph.  A capture that fails raises: nothing falls back to the eager
  step.
* The kernel wrappers count their launches only while Python runs, so a
  capture records how far each count moved and every replay adds that.
  Counts kept on the device (`kernels.device_count.DeviceCount`, the remote
  experts run) are added by the graph itself.
* On the CPU there is no graph: a :class:`StepGraph` runs the same step
  over the same fixed buffers eagerly, so buckets, counters and staging
  behave as on the card.
* ``after_first_run`` is called once a step has first run eagerly (the
  warm-up on the card, before the capture): the engine seals the
  bucket's autotuner lookups there (`kernels.autotune.RecordedLookups`),
  so a capture and its replays, like a jitted step's calls, count no hit.
"""
from __future__ import annotations

import math
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.tiering import TieredTensor
from repro_torch.kernels.splitk_flashattn import paged_splitk_flashattn, scatter_rows
from repro_torch.kernels.splitk_gemm import splitk_gemm, splitk_gemm_grouped

# The wrappers whose ``launches`` count the kernels a decode step launches.
LAUNCH_COUNTERS = (splitk_gemm, splitk_gemm_grouped, paged_splitk_flashattn, scatter_rows)
PAGED_INPUTS = ("tokens", "positions", "attn_lens", "table", "tier", "wr_tier", "wr_idx",
                "wr_off")


def pointer_fingerprint(tree: Any) -> tuple[int, ...]:
    """The addresses of a params tree's tensors (both tiers of a tiered
    operand), in tree order: what a captured step has baked in."""
    out: list[int] = []

    def walk(node: Any) -> None:
        if isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, TieredTensor):
            out.extend((node.local.data_ptr(), node.remote.data_ptr()))
        elif isinstance(node, torch.Tensor):
            out.append(node.data_ptr())

    walk(tree)
    return tuple(out)


class StepInputs:
    """Fixed int32 buffers for a decode step's inputs and the pinned
    staging that fills them.  ``paged=False`` (a pure SSM) holds tokens
    only."""

    def __init__(self, batch: int, max_pages: int, device: torch.device, *, paged: bool):
        shapes = {"tokens": (batch, 1)}
        if paged:
            shapes.update(positions=(batch,), attn_lens=(batch,), table=(batch, max_pages),
                          tier=(batch, max_pages), wr_tier=(batch,), wr_idx=(batch,),
                          wr_off=(batch,))
        # each buffer starts on a 16-byte boundary
        sizes = {name: -(-math.prod(shape) // 4) * 4 for name, shape in shapes.items()}
        total = sum(sizes.values())
        pin = device.type == "cuda"
        self._host = torch.zeros(total, dtype=torch.int32, pin_memory=pin)
        self._dev = torch.zeros(total, dtype=torch.int32, device=device)
        host_np = self._host.numpy()
        self.buffers: dict[str, torch.Tensor] = {}
        self._staging: dict[str, np.ndarray] = {}
        off = 0
        for name, shape in shapes.items():
            n = math.prod(shape)
            self.buffers[name] = self._dev[off:off + n].view(shape)
            self._staging[name] = host_np[off:off + n].reshape(shape)
            off += sizes[name]
        self._tokens_host = torch.zeros(batch, dtype=torch.int32, pin_memory=pin)
        self._fetched = torch.cuda.Event() if pin else None

    def load(self, **values: np.ndarray) -> None:
        """Stage this step's value of every input and move them all into the
        fixed buffers with one copy.  The staging buffer is free again: the
        previous step's copy finished before its tokens were fetched."""
        for name, staged in self._staging.items():
            staged[...] = values[name]
        self._dev.copy_(self._host, non_blocking=True)

    def fetch(self, tokens: torch.Tensor) -> np.ndarray:
        """The step's ``[B]`` tokens on the host, once the step is done."""
        self._tokens_host.copy_(tokens, non_blocking=True)
        if self._fetched is not None:
            self._fetched.record()
            self._fetched.synchronize()
        return self._tokens_host.numpy().copy()


_CAPTURE_STREAMS: dict[int, torch.cuda.Stream] = {}


def capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The side stream every engine on ``device`` warms up and captures its
    steps on, one per device for the process.  PyTorch keeps a cuBLAS
    workspace (32 MiB on Hopper) for every stream a product ran on until
    the process ends, so a stream of each engine's own would hold one more
    workspace for every engine ever built."""
    index = torch.cuda.current_device() if device.index is None else device.index
    stream = _CAPTURE_STREAMS.get(index)
    if stream is None:
        stream = _CAPTURE_STREAMS[index] = torch.cuda.Stream(index)
    return stream


def _launch_counts() -> tuple[int, ...]:
    return tuple(c.launches for c in LAUNCH_COUNTERS)


class StepGraph:
    """One bucket's decode step: ``fn(*state)`` runs the step over the fixed
    input buffers and the engine's state (params, pools, recurrent state)
    and returns its ``[B]`` int32 tokens on the device.

    On the card the first :meth:`run` warms the step up eagerly on the
    side ``stream`` and captures it there into a graph drawing from the
    shared memory ``pool``; later runs replay it on the current stream,
    over the state it was captured with (a replay ignores its arguments).
    :meth:`drop` releases the graph; the next run captures it again."""

    def __init__(self, fn: Callable[..., torch.Tensor], device: torch.device, *,
                 pool: Any = None, stream: torch.cuda.Stream | None = None,
                 after_first_run: Callable[[], None] | None = None):
        self.fn = fn
        self.device = device
        self.pool = pool
        self.stream = stream
        self.after_first_run = after_first_run   # called once the step has run eagerly
        self.graph: torch.cuda.CUDAGraph | None = None
        self.tokens: torch.Tensor | None = None   # the graph's output buffer
        self.captured = False
        self.captures = 0             # captures made, the first included
        self.capture_s = 0.0          # wall time of the last warm-up and capture
        self.pool_bytes = 0           # device memory the captures added to the pool
        self._replay_launches: tuple[int, ...] = ()

    def run(self, *state: Any) -> torch.Tensor:
        if self.device.type != "cuda":
            tokens = self.fn(*state)  # no graph on the CPU: the same step, eagerly
            if not self.captured:
                self.captured = True
                self.captures += 1
                self._first_run_done()
            return tokens
        if not self.captured:
            return self._capture(state)
        self.graph.replay()
        for counter, n in zip(LAUNCH_COUNTERS, self._replay_launches):
            counter.launches += n
        return self.tokens

    def _capture(self, state: tuple) -> torch.Tensor:
        """Warm up on the side stream (this step's real run, whose tokens
        are returned), then capture the same step.  A capture launches
        nothing, so the launch counts it moved are taken back and added
        again on every replay."""
        t0 = time.perf_counter()
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            tokens = self.fn(*state)
        current.wait_stream(self.stream)
        self._first_run_done()
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        before = _launch_counts()
        graph = torch.cuda.CUDAGraph()
        try:
            # The global error mode: the wrappers' host calls during capture
            # (cudaPointerGetAttributes, is_pinned, cudaFuncSetAttribute,
            # the tensor-map encoder) are all legal in it.
            with torch.cuda.graph(graph, pool=self.pool, stream=self.stream,
                                  capture_error_mode="global"):
                out = self.fn(*state)
        except Exception as e:
            raise RuntimeError(f"capturing the decode step as a CUDA graph failed: {e}") from e
        finally:
            moved = tuple(a - b for a, b in zip(_launch_counts(), before))
            for counter, n in zip(LAUNCH_COUNTERS, moved):
                counter.launches -= n
        self.graph, self.tokens, self._replay_launches = graph, out, moved
        self.captured = True
        self.captures += 1
        self.pool_bytes += torch.cuda.memory_reserved(self.device) - reserved
        self.capture_s = time.perf_counter() - t0
        return tokens

    def _first_run_done(self) -> None:
        if self.after_first_run is not None:
            self.after_first_run()

    def drop(self) -> None:
        """Release the graph: the addresses it holds are about to change."""
        self.graph = self.tokens = None
        self.captured = False
