"""Materialization lint (DAK001-003): the direct-access guarantee, checked
mechanically on the aten ops a step runs.

DAK's core design rule is that remote-tier data is *never* staged through
HBM: the kernels read weights and KV pages from pinned host memory tile by
tile into shared memory, and under a mesh each shard crosses a host link
once into the sanctioned `kernels.ops.gather_shards` all-gather.  Token
parity cannot see a regression that copies a remote tier into HBM and
computes there: the numbers stay the same, only the design reverts to
prefetching.

So this lint runs each family's decode / prefill / chunked-prefill entry
point under a ``TorchDispatchMode`` that sees every aten op the eager step
really runs, on meta tensors at full size (no allocation), on CPU tensors
in the tests and on pinned and CUDA tensors on the card, and follows a
taint through them:

- taint **enters** at every remote leaf: a `TieredTensor`'s remote tier or
  shard, or a tensor marked by `surface.mark_remote` (a remote KV pool);
- taint **propagates** through views, reshapes, slices, index/gather ops,
  elementwise ops and dtype casts, and through Python loops and in-place
  carries (the port's stand-in for the reference's scan/while/cond); an
  in-place op on a view taints its base too;
- taint is **consumed** (the outputs are clean) by contractions (mm, bmm,
  addmm, baddbmm, linear, convolution, SDPA), reductions (sum, amax, amin,
  prod, any, all, logsumexp, cumsum, argmax, argmin, sort, topk, ...), the
  c10d collectives, and the direct-access entry points marked with
  `kernels.sink.direct_access`, which run opaquely as the reference's lint
  treats ``pallas_call``;
- taint **fires** at HBM-materialization points: ``cat``/``stack`` with a
  tainted operand; a write (``copy_``, ``index_put_``, ``index_copy_``,
  ``scatter*``, ``slice_scatter``, ``select_scatter``, ``masked_scatter``,
  ...) whose source is tainted and whose target is not (a write *into* a
  remote pool keeps the pool's own taint and is sanctioned); and, a rule
  of the port's own, a ``_to_copy`` or ``copy_`` that moves tainted data
  from its device onto another one that is not the host: pinned host
  memory into HBM, the card's exact anti-pattern (moving it back to the
  host is a write into the remote tier).

Each finding is reported once, with the aten op and the Python source line
that ran it, under the rule of the pass that traced it: DAK001 (decode),
DAK002 (prefill / chunked prefill), DAK003 (the remote KV pools alone).
What fired is not tainted downstream.  A trace that cannot run raises; it
is never reported as green.

Counterpart of ``src/repro/analysis/materialization.py`` (a jaxpr walk
there); the same entry points, trace sizes and rule IDs.
"""
from __future__ import annotations

import sys
from pathlib import Path
from typing import Any, Callable, Iterable

import torch
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.analysis import surface
from repro_torch.analysis.findings import Finding
from repro_torch.kernels import sink

# Sanctioned consumers (overload packets): ops that read tainted data
# without copying it into a buffer of comparable extent.
_KILL = frozenset({
    "mm", "bmm", "addmm", "addbmm", "baddbmm", "addmv", "mv", "dot", "vdot", "matmul",
    "linear", "_int_mm", "_scaled_mm", "convolution", "_convolution",
    "scaled_dot_product_attention", "_scaled_dot_product_flash_attention",
    "_scaled_dot_product_efficient_attention", "_scaled_dot_product_cudnn_attention",
    "_scaled_dot_product_flash_attention_for_cpu",
    "sum", "nansum", "mean", "amax", "amin", "prod", "any", "all", "logsumexp",
    "var", "std", "var_mean", "std_mean", "norm", "linalg_vector_norm",
    "cumsum", "cumprod", "cummax", "cummin", "logcumsumexp",
    "argmax", "argmin", "sort", "topk",
})
# max/min reduce in these overloads (``max.other`` is elementwise).
_REDUCING = {"max": ("default", "dim", "names_dim"), "min": ("default", "dim", "names_dim")}
_COLLECTIVES = frozenset({"c10d", "_c10d_functional", "c10d_functional"})
_CONCAT = frozenset({"cat", "_cat", "concat", "concatenate", "stack", "hstack", "vstack"})
# Writes of a source into a target: fire on a tainted source into a clean target.
_WRITES = frozenset({
    "copy_", "copy", "index_put", "index_put_", "_index_put_impl_", "_unsafe_index_put",
    "index_copy", "index_copy_", "index_add", "index_add_", "index_reduce", "index_reduce_",
    "scatter", "scatter_", "scatter_add", "scatter_add_", "scatter_reduce", "scatter_reduce_",
    "slice_scatter", "select_scatter", "diagonal_scatter", "as_strided_scatter",
    "masked_scatter", "masked_scatter_", "put", "put_",
})
_SOURCE_ARGS = ("src", "source", "values")
_DEVICE_MOVES = frozenset({"_to_copy", "copy_"})

_TORCH_DIR = str(Path(torch.__file__).resolve().parent)
_SKIP_FILES = {str(Path(__file__).resolve()), str(Path(sink.__file__).resolve())}
_REPO = Path(__file__).resolve().parents[3]


def _tensors(tree: Any) -> list[torch.Tensor]:
    """The tensors of an op's arguments or outputs (nested tuples, lists
    and dicts)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = tuple(tree.values())
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _tensors(x)]
    return []


def _source_line() -> str:
    """The innermost Python frame outside torch and this lint: where the op
    was called from."""
    frame = sys._getframe(1)
    while frame is not None:
        path = str(Path(frame.f_code.co_filename).resolve())
        if not path.startswith(_TORCH_DIR) and path not in _SKIP_FILES:
            try:
                path = str(Path(path).relative_to(_REPO))
            except ValueError:
                pass
            return f"{path}:{frame.f_lineno} ({frame.f_code.co_name})"
        frame = frame.f_back
    return "<unknown>"


class MaterializationLint(TorchDispatchMode):
    """A taint walk over every aten op run while the context is open.

    ``seed`` marks the remote tensors before the run; ``findings`` holds
    what fired, ``ops`` the aten ops walked and ``sinks`` the direct-access
    entry points run opaquely."""

    def __init__(self, *, rule: str = "DAK001", where: str = "trace"):
        super().__init__()
        self.rule, self.where = rule, where
        self.findings: list[Finding] = []
        self.ops = 0
        self.sinks = 0
        self._taint = WeakIdKeyDictionary()
        self._reported: set[tuple[str, str, str]] = set()
        self._prev_hook: Callable[..., Any] | None = None

    # -- taint ---------------------------------------------------------
    def seed(self, tensors: Iterable[torch.Tensor]) -> None:
        for t in tensors:
            self._taint[t] = True

    def tainted(self, t: torch.Tensor) -> bool:
        if self._taint.get(t, False):
            return True
        base = t._base
        return base is not None and self._taint.get(base, False)

    def _set(self, t: torch.Tensor) -> None:
        self._taint[t] = True
        if t._base is not None:
            self._taint[t._base] = True

    def _emit(self, func, kind: str, detail: str) -> None:
        line = _source_line()
        key = (kind, str(func), line)
        if key in self._reported:
            return
        self._reported.add(key)
        self.findings.append(Finding(self.rule, self.where, f"{detail} at {line}",
                                     context={"primitive": str(func), "kind": kind}))

    # -- the mode ------------------------------------------------------
    def __enter__(self):
        self._prev_hook, sink._hook = sink._hook, self._sink
        return super().__enter__()

    def __exit__(self, *exc):
        sink._hook = self._prev_hook
        return super().__exit__(*exc)

    def _sink(self, fn, plain, args, kwargs):
        """A direct-access entry point: run opaquely (the lint and the hook
        suspended), its outputs clean; on the meta device its plain version
        gives their shapes."""
        self.sinks += 1
        abstract = any(t.device.type == "meta" for t in _tensors((args, kwargs)))
        prev, sink._hook = sink._hook, None
        try:
            with _disable_current_modes():
                return (plain if abstract else fn)(*args, **kwargs)
        finally:
            sink._hook = prev

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.ops += 1
        ins = _tensors((args, kwargs))
        any_t = any(self.tainted(t) for t in ins)
        out = func(*args, **kwargs)
        if not any_t:
            return out
        name = func.overloadpacket.__name__
        schema = func._schema
        mutated = [_arg(args, kwargs, i, a.name) for i, a in enumerate(schema.arguments)
                   if a.alias_info is not None and a.alias_info.is_write]
        if (func.namespace in _COLLECTIVES or name in _KILL
                or func._overloadname in _REDUCING.get(name, ())):
            return out
        if name in _CONCAT:
            shape = tuple(_tensors(out)[0].shape)
            self._emit(func, "concat", "remote-tier data concatenated into an HBM-resident "
                                       f"buffer {shape}")
            return out
        if name in _DEVICE_MOVES:
            src = args[0] if name == "_to_copy" else _arg(args, kwargs, 1, "src")
            dst = out
            if (isinstance(src, torch.Tensor) and self.tainted(src)
                    and dst.device != src.device and dst.device.type != "cpu"):
                self._emit(func, "device-move", f"remote-tier data moved from {src.device} "
                                                f"onto {dst.device} into a buffer "
                                                f"{tuple(dst.shape)}")
                return out
        if name in _WRITES:
            target = args[0]
            source = next((_arg(args, kwargs, i, a.name)
                           for i, a in enumerate(schema.arguments) if a.name in _SOURCE_ARGS),
                          None)
            target_t = self.tainted(target)
            if isinstance(source, torch.Tensor) and self.tainted(source) and not target_t:
                self._emit(func, "update", "remote-derived update written into an "
                                           f"HBM-resident buffer {tuple(target.shape)}")
            if target_t and not mutated:
                for o in _tensors(out):
                    self._set(o)
            return out
        for t in _tensors(mutated) or _tensors(out):
            self._set(t)
        return out


def _arg(args: tuple, kwargs: dict, i: int, name: str) -> Any:
    return args[i] if i < len(args) else kwargs.get(name)


def remote_mask(args: tuple[Any, ...]) -> list[bool]:
    """Per-flat-leaf remote flags, in the reference's flatten order."""
    return [remote for _, remote in surface.flatten(args)]


def lint_traced(fn: Callable[..., Any], args: tuple[Any, ...], *,
                rule: str, where: str) -> list[Finding]:
    """Run ``fn(*args)`` under the lint, its remote leaves seeded
    (`remote_mask`), and return the findings."""
    with MaterializationLint(rule=rule, where=where) as lint:
        lint.seed(leaf for leaf, remote in surface.flatten(args) if remote)
        fn(*args)
    return lint.findings


def engine_remote_tensors(eng) -> list[torch.Tensor]:
    """Every remote buffer a `ServingEngine` holds: each tiered weight's
    remote tier (and its shard under a mesh) and every remote KV buffer of
    its paged cache; the seeds of a lint around ``eng.step()``."""
    out = [leaf for leaf, remote in surface.flatten(eng.params) if remote]
    if eng.pcache is not None:
        out += eng.pcache.remote_buffers()
    return out


# --------------------------------------------------------------------------
# Family entry points
# --------------------------------------------------------------------------
_B = 2            # trace batch (any batch traces the same program structure)
_T = 8            # trace prompt length
_PS = 16          # trace page size
_POOL = 4         # pages per tier pool (+1 sink added by the layout)
_MP = 4           # max pages per slot
_WINDOW = 2


def _tok(shape: tuple[int, ...]) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.int32, device="meta")


def _decode_args(cfg) -> tuple[tuple[Any, ...], dict[str, Any]]:
    pools = surface.abstract_kv_pools(
        cfg, local_pages=_POOL, remote_pages=_POOL, page_size=_PS)
    args = (pools, _tok((_B, 1)), _tok((_B,)), _tok((_B,)),
            _tok((_B, _MP)), _tok((_B, _MP)), _tok((_B,)), _tok((_B,)), _tok((_B,)))
    kw = {"sink_local": _POOL, "sink_remote": _POOL, "window": _WINDOW}
    return args, kw


def _recurrent_cache(cfg) -> dict[str, torch.Tensor]:
    from repro_torch.models import model as M

    cache = M.init_cache(cfg, _B, _T, device="meta")
    return {k: v for k, v in cache.items() if k in ("conv", "state")}


def _lint_decode(cfg, params, *, rule: str, where: str) -> list[Finding]:
    from repro_torch.serving import tiered_decode as TD

    if cfg.family == "ssm":
        return lint_traced(
            lambda p, c, t: TD.tiered_ssm_decode_step(cfg, p, c, t, window=_WINDOW),
            (params, _recurrent_cache(cfg), _tok((_B, 1))), rule=rule, where=where)
    dargs, kw = _decode_args(cfg)
    if cfg.family == "hybrid":
        return lint_traced(
            lambda p, c, pl, *rest: TD.tiered_hybrid_decode_step(cfg, p, c, pl, *rest, **kw),
            (params, _recurrent_cache(cfg)) + dargs, rule=rule, where=where)
    return lint_traced(
        lambda p, pl, *rest: TD.paged_tiered_decode_step(cfg, p, pl, *rest, **kw),
        (params,) + dargs, rule=rule, where=where)


def lint_family(cfg, plan, *, align: int = 1,
                passes: tuple[str, ...] = ("decode", "prefill", "chunk"),
                where: str = "") -> list[Finding]:
    """Run the materialization lint over one family's serving entry points
    with the plan's realized tier split (abstract, full-size), each with
    the ``mm`` the serving engine passes (`serving.tiered_decode.kernel_mm`)."""
    from repro_torch.models import model as M
    from repro_torch.serving import tiered_decode as TD

    params = surface.partition_abstract(cfg, plan, align=align)
    mm = TD.kernel_mm(_WINDOW)
    findings: list[Finding] = []

    if "decode" in passes:
        findings += _lint_decode(cfg, params, rule="DAK001", where=f"{where}/decode")

    if "prefill" in passes:
        findings += lint_traced(
            lambda p, t: M.prefill(cfg, p, {"tokens": t}, mm=mm)[0],
            (params, _tok((_B, _T))), rule="DAK002", where=f"{where}/prefill")

    if "chunk" in passes:
        cache = M.init_cache(cfg, _B, 2 * _T, device="meta")
        findings += lint_traced(
            lambda p, c, t: M.prefill_chunk(cfg, p, c, t, _T, mm=mm)[0],
            (params, cache, _tok((_B, _T))), rule="DAK002",
            where=f"{where}/chunked-prefill")

    # DAK003: the remote KV pools alone (weights untiered): the paged decode
    # path never gathers a host-resident pool into HBM even when no weight
    # is offloaded.
    if "decode" in passes and cfg.family != "ssm":
        findings += _lint_decode(cfg, surface.abstract_params(cfg), rule="DAK003",
                                 where=f"{where}/kv-pools")
    return findings
