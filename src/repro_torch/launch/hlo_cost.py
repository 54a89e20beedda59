"""Per-device cost of a step traced under DTensor on fake tensors.

Counterpart of ``src/repro/launch/hlo_cost.py``.  The reference re-derives
roofline inputs from the compiled HLO text of an SPMD module; the port has
no compiled module, so it counts a trace instead.  The step runs once on
DTensors whose local shards are fake tensors (``FakeTensorMode``: shapes,
dtypes and strides, no storage) over a fake process group, under two
dispatch modes:

* `_GlobalCounter`, above DTensor, sees every aten op with its global
  shapes and its output's placements.  It counts the FLOPs of the ops in
  ``torch.utils.flop_counter``'s registry (mm, addmm, bmm, baddbmm, the
  convolutions and attentions; an einsum reaches it as permutes, views and
  a bmm) per device: ``global x (local output numel / global output
  numel) / prod(mesh sizes of the dims where the output is Partial)``.
  Where DTensor has no sharding strategy for an op (or its propagation
  fails), the op runs on its inputs replicated over the fewest trailing
  mesh dims that give it a plan, as XLA's partitioner does when it has no
  better one; the redistribution is counted like any other collective and
  the op is listed in ``replicated_ops`` with its count and collective
  bytes.  A few ops run in the trace's own sharded form where DTensor
  would gather a whole dim (``sharded_ops``): a softmax or logsumexp over
  a sharded dim (local max and sum, all-reduced), a split along one, and,
  through `_ShardedFunctions` at the function level, a gather along one
  (`_ShardedGather`, with its gradient) and ``t[i] = v`` into one.  A dot
  never reads a Partial operand: it is all-reduced first.
* `_LocalCounter`, beneath DTensor, sees the local ops DTensor issues on
  the shards, the collectives of its redistributions and every op on plain
  tensors.  It counts bytes and collectives:

  - bytes are the local input and output bytes of every aten op that
    moves data (a stride-0 dimension of an expanded input is read once).
    Views, metadata queries and allocations move nothing; an in-place write
    into a slice of a buffer (``copy_`` into a view, ``index_put_``,
    ``slice_scatter``, ``index_copy_``, ``scatter_``) counts twice the update
    region, as the reference counts a dynamic-update-slice; a gather
    (``index``, ``gather``, ``index_select``, ``embedding``) twice its
    output.  This is unfused aten traffic: an upper bound beside XLA's
    count of fused HLO instructions (`BYTES_BASIS`).
  - a collective's payload is the larger of its local input and output,
    and the ring factor is `hlo_analysis._TRAFFIC_FACTOR`'s.  The fake
    shards live on the CPU, and on a "cpu" DeviceMesh DTensor rewrites an
    all-to-all as an all-gather and a chunk.  The count classifies by the
    op DTensor asked for instead: while a `TraceCounter` is entered,
    DTensor's ``shard_dim_alltoall`` issues ``_dtensor.shard_dim_alltoall``
    on every mesh, which is counted as an all-to-all and answered with an
    empty tensor of the output's shape (`_asked_alltoall`).

All figures are per device (this process is rank 0 of the fake group; the
mesh is uniform, so every rank's counts are the same).  The peak of live
local bytes counts each storage the trace made once while a tensor on it
lives.  `TraceCounter.scan`
is the trip count: a loop body run once inside it counts n times, as
the reference multiplies a while body by its ``known_trip_count``.
"""
from __future__ import annotations

import contextlib
import dataclasses
from collections import defaultdict
from typing import Any, Callable

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_unflatten

from repro_torch.launch.hlo_analysis import _TRAFFIC_FACTOR

BYTES_BASIS = ("unfused aten: local input + output bytes of every data-moving op; an "
               "upper bound beside XLA's fused count")

aten = torch.ops.aten

_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "broadcast": "collective-permute",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d_functional", "_dtensor",
                          "_c10d_functional_autograd")
# ops that move no data: metadata, allocation, aliasing, synchronisation
_FREE = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
         "_unsafe_view", "alias", "detach", "lift_fresh", "_local_scalar_dense",
         "wait_tensor", "sym_size", "sym_stride", "sym_numel", "is_contiguous",
         "_to_copy_noop", "resize_", "set_", "record_stream"}
# in-place writes of a region: twice the region written, the argument at
# this position (the destination view of a copy_, else the values written)
_REGION_WRITES = {"copy_": 0, "slice_scatter": 1, "select_scatter": 1, "index_put_": 2,
                  "_index_put_impl_": 2, "masked_scatter_": 2, "index_copy_": 3,
                  "scatter_": 3}
# gathers: twice the output, as the reference counts gather / dynamic-slice
_GATHERS = {"index", "gather", "index_select", "embedding"}


def _name(func) -> str:
    return func._schema.name.split("::")[-1]


def _namespace(func) -> str:
    return func._schema.name.split("::")[0]


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes a kernel reads or writes of `t`: its elements, a stride-0
    (expanded) dimension counted once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _tensors(tree) -> list[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _dtype_name(dtype: torch.dtype) -> str:
    return {torch.bfloat16: "bf16", torch.float16: "f16", torch.float32: "f32",
            torch.float64: "f64", torch.int32: "s32", torch.int64: "s64",
            torch.bool: "pred", torch.int8: "s8", torch.uint8: "u8"}.get(dtype, str(dtype))


def shape_key(t: torch.Tensor) -> str:
    """A per-device shape in the reference's HLO spelling, e.g. ``bf16[8,4096]``."""
    return f"{_dtype_name(t.dtype)}[{','.join(str(d) for d in t.shape)}]"


@dataclasses.dataclass
class HloCost:
    flops: float
    bytes: float
    collective_bytes: float                  # with ring factors applied
    collective_by_kind: dict[str, float]
    collective_counts: dict[str, int]
    dot_flops_by_shape: dict[str, float]
    # the port's additions: raw payloads, the ops run replicated, the ops
    # run in the trace's own sharded form, the local FLOPs beneath DTensor
    # (a check of the per-device rule), the step's argument and output shards
    collective_raw_by_kind: dict[str, float] = dataclasses.field(default_factory=dict)
    replicated_ops: dict[str, dict[str, float]] = dataclasses.field(default_factory=dict)
    sharded_ops: dict[str, float] = dataclasses.field(default_factory=dict)
    local_flops: float = 0.0
    argument_bytes: float = 0.0
    output_bytes: float = 0.0
    peak_live_bytes: float | None = None
    bytes_basis: str = BYTES_BASIS


class _Totals:
    """What the two modes add to, each figure times the current trip count."""

    def __init__(self) -> None:
        self.mult = 1.0
        self.flops = 0.0
        self.local_flops = 0.0
        self.bytes = 0.0
        self.coll_raw: dict[str, float] = defaultdict(float)
        self.coll_n: dict[str, float] = defaultdict(float)
        self.dots: dict[str, float] = defaultdict(float)
        self.replicated: dict[str, dict[str, float]] = {}
        self.sharded: dict[str, float] = {}
        # live bytes of the storages the trace made: each storage counted
        # once while any tensor on it lives (a finalizer on each tensor)
        self.live = 0
        self.peak = 0
        self.held: set[int] = set()
        self.refs: dict[int, int] = {}

    def snapshot(self) -> tuple:
        return self.bytes, self.local_flops, dict(self.coll_raw), dict(self.coll_n)

    def restore(self, snap: tuple) -> None:
        self.bytes, self.local_flops = snap[0], snap[1]
        self.coll_raw = defaultdict(float, snap[2])
        self.coll_n = defaultdict(float, snap[3])

    def track(self, outs: list) -> None:
        import weakref

        for x in outs:
            st = x.untyped_storage()
            key = st._cdata
            if key in self.held:
                continue
            if key not in self.refs:
                self.refs[key] = 0
                self.live += st.nbytes()
                self.peak = max(self.peak, self.live)
            self.refs[key] += 1
            weakref.finalize(x, self._release, key, st.nbytes())

    def _release(self, key: int, nbytes: int) -> None:
        self.refs[key] -= 1
        if not self.refs[key]:
            del self.refs[key]
            self.live -= nbytes

    def coll_bytes(self) -> float:
        return sum(self.coll_raw.values())


def _partial_size(t: DTensor) -> int:
    n = 1
    for dim, p in enumerate(t.placements):
        if isinstance(p, Partial):
            n *= t.device_mesh.size(dim)
    return n


def _op_flops(func, args, kwargs, out) -> float:
    from torch.utils.flop_counter import flop_registry

    fn = flop_registry.get(func._overloadpacket)
    return 0.0 if fn is None else float(fn(*args, **kwargs, out_val=out))


class _LocalCounter(TorchDispatchMode):
    """Beneath DTensor: bytes, collectives and local FLOPs of the shards."""

    def __init__(self, totals: _Totals, fake_mode=None):
        super().__init__()
        self.t = totals
        self.fake_mode = fake_mode

    def _foreign(self, tree) -> bool:
        """An op on (or making) another fake mode's tensors: DTensor deriving
        an output's global shape and strides, which no device runs."""
        from torch._subclasses.fake_tensor import FakeTensor

        return self.fake_mode is not None and any(
            isinstance(x, FakeTensor) and x.fake_mode is not self.fake_mode
            for x in _tensors(tree))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if isinstance(func, torch._ops.HigherOrderOperator) or self._foreign((args, kwargs)):
            return func(*args, **kwargs)
        name, t = _name(func), self.t
        kind = _COLLECTIVES.get(name) if _namespace(func) in _COLLECTIVE_NAMESPACES else None
        if name == "shard_dim_alltoall":
            x, gather_dim, shard_dim, group = args[:4]
            from torch.distributed.distributed_c10d import _resolve_process_group

            size = (_resolve_process_group(group) if isinstance(group, str) else group).size()
            shape = list(x.shape)
            shape[gather_dim] *= size
            shape[shard_dim] //= size
            out = x.new_empty(shape)
        else:
            out = func(*args, **kwargs)
            if self._foreign(out):
                return out
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        t.track(outs)
        if kind is not None:
            payload = max(sum(tensor_bytes(x) for x in ins), sum(tensor_bytes(x) for x in outs))
            t.coll_raw[kind] += t.mult * payload
            t.coll_n[kind] += t.mult
            t.bytes += t.mult * (sum(tensor_bytes(x) for x in ins + outs))
            return out
        t.local_flops += t.mult * _op_flops(func, args, kwargs, out)
        t.bytes += t.mult * _moved_bytes(func, name, args, ins, outs)
        return out


def _moved_bytes(func, name: str, args, ins: list, outs: list) -> float:
    if name in _FREE or func.is_view or _namespace(func) == "prim":
        return 0.0
    if name in _REGION_WRITES:
        pos = _REGION_WRITES[name]
        region = args[pos] if len(args) > pos else None
        if not isinstance(region, torch.Tensor):        # a scalar scattered: its index
            region = args[2]
        return 2.0 * tensor_bytes(region)
    if name in _GATHERS:
        return 2.0 * sum(tensor_bytes(x) for x in outs)
    return float(sum(tensor_bytes(x) for x in ins + outs))


def _reduces_sharded_dim(x, dims) -> bool:
    """Whether a reduction of DTensor `x` over `dims` crosses a sharded dim."""
    from torch.distributed.tensor import Shard

    if not isinstance(x, DTensor):
        return False
    dims = [dims] if isinstance(dims, int) else list(dims)
    dims = {d % x.dim() for d in dims}
    return any(isinstance(p, Shard) and p.dim in dims for p in x.placements)


def _sharded_softmax(x, dim, half_to_float=False):
    """Softmax over a sharded dim as a split-K partitioner computes it: the
    local max and sum, each all-reduced (a vector of the reduced shape),
    the output left sharded."""
    m = torch.amax(x, dim, keepdim=True)
    e = torch.exp(x - m)
    out = e / e.sum(dim, keepdim=True)
    return out.float() if half_to_float else out


def _sharded_logsumexp(x, dims, keepdim=False):
    """logsumexp over a sharded dim: the local max and sum all-reduced."""
    m = torch.amax(x, dims, keepdim=True)
    out = torch.log(torch.exp(x - m).sum(dims, keepdim=True)) + m
    return out if keepdim else out.squeeze(dims)


def _is_dot(func) -> bool:
    from torch.utils.flop_counter import flop_registry

    return func._overloadpacket in flop_registry


def _reduced(tree):
    """Every partial-sum DTensor of `tree` reduced (all-reduced over its
    Partial mesh dims, its shards kept).  A dot never reads a partial
    operand: an SPMD partitioner reduces a dot's partial output where it
    is produced, and DTensor would otherwise carry it through the next
    dot on every rank of the dim, computing it there in full."""
    def reduce(x):
        if isinstance(x, DTensor) and any(isinstance(p, Partial) for p in x.placements):
            return x.redistribute(x.device_mesh, [Replicate() if isinstance(p, Partial) else p
                                                  for p in x.placements])
        return x

    flat, spec = tree_flatten(tree)
    return tree_unflatten([reduce(x) for x in flat], spec)


def _split_sizes(extent: int, sizes) -> list[int]:
    if isinstance(sizes, int):
        return [min(sizes, extent - s) for s in range(0, extent, sizes)]
    return list(sizes)


def _shard_count(x: DTensor, dim: int) -> int:
    from torch.distributed.tensor import Shard

    n = 1
    for mdim, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim == dim:
            n *= x.device_mesh.size(mdim)
    return n


def _split_keeps_shards(x, sizes, dim: int = 0) -> bool:
    """A split of DTensor `x` along a sharded dim whose every piece the
    dim's shards divide (no Partial input)."""
    if not isinstance(x, DTensor) or any(isinstance(p, Partial) for p in x.placements):
        return False
    dim %= x.dim()
    n = _shard_count(x, dim)
    return n > 1 and all(s % n == 0 for s in _split_sizes(x.shape[dim], sizes))


_SPLITS = {aten.split.Tensor, aten.split_with_sizes.default}


class _ShardedGather(torch.autograd.Function):
    """``gather`` along a sharded dim as a vocab-parallel partitioner does
    it: each shard gathers at its local offsets, masked where the index is
    not its own, and one all-reduce over the dim's mesh dims completes the
    output.  The gradient is scattered the same way into a zero tensor of
    the input's shards (where DTensor's own backward would build the whole
    dim on every rank)."""

    @staticmethod
    def forward(ctx, x: DTensor, dim: int, index):
        from torch.distributed.tensor import Shard

        mesh = x.device_mesh
        dim %= x.dim()
        over = [isinstance(p, Shard) and p.dim == dim for p in x.placements]
        if not isinstance(index, DTensor):
            index = DTensor.from_local(index, mesh, [Replicate()] * mesh.ndim, run_check=False)
        out_pl = [Replicate() if o else p for o, p in zip(over, x.placements)]
        idx = index.redistribute(mesh, out_pl)._local_tensor
        loc = x._local_tensor
        near = idx.clamp(0, loc.shape[dim] - 1)
        keep = near == idx
        out = torch.where(keep, torch.gather(loc, dim, near),
                          torch.zeros((), dtype=loc.dtype, device=loc.device))
        ctx.meta = (mesh, dim, out_pl, x.placements, loc.shape)
        ctx.near, ctx.keep = near, keep
        partial = DTensor.from_local(out, mesh, [Partial() if o else p
                                                 for o, p in zip(over, x.placements)],
                                     run_check=False)
        return partial.redistribute(mesh, out_pl)

    @staticmethod
    def backward(ctx, grad: DTensor):
        mesh, dim, out_pl, x_pl, loc_shape = ctx.meta
        g = grad.redistribute(mesh, out_pl)._local_tensor
        g = torch.where(ctx.keep, g, torch.zeros((), dtype=g.dtype, device=g.device))
        gx = torch.zeros(loc_shape, dtype=g.dtype, device=g.device).scatter_add(dim, ctx.near, g)
        return DTensor.from_local(gx, mesh, x_pl, run_check=False), None, None


_SHARDED_REDUCTIONS = {aten._softmax.default: _sharded_softmax,
                       aten.logsumexp.default: _sharded_logsumexp}


class _ShardedFunctions(torch.overrides.TorchFunctionMode):
    """A ``gather`` along a sharded dim (`_ShardedGather`), and
    ``t[index] = value`` into a DTensor whose indexed dim is sharded,
    done in place on each shard as XLA partitions a dynamic-update-slice:
    the value is brought to the placements of the region written (no
    gather of `t`), and the shard writes it at its local offset (this rank
    stands for the owner: the cost is the same).  An index this cannot
    place (a tensor, a step, a span across shards) takes DTensor's path."""

    def __init__(self, totals: _Totals):
        super().__init__()
        self.t = totals

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        sharded = self.t.sharded
        if func is torch.Tensor.__setitem__ and isinstance(args[0], DTensor) \
                and _local_setitem(*args):
            sharded["__setitem__"] = sharded.get("__setitem__", 0.0) + self.t.mult
            return None
        if func in (torch.gather, torch.Tensor.gather) and not kwargs and len(args) == 3 \
                and _reduces_sharded_dim(args[0], args[1]):
            sharded["gather"] = sharded.get("gather", 0.0) + self.t.mult
            return _ShardedGather.apply(*args)
        return func(*args, **kwargs)


def _local_setitem(target: DTensor, index, value) -> bool:
    from torch.distributed.tensor import Shard

    index = index if isinstance(index, tuple) else (index,)
    if any(not isinstance(i, (int, slice)) for i in index) or len(index) > target.dim():
        return False
    sharded = {p.dim for p in target.placements if isinstance(p, Shard)}
    if not any(d in sharded and not (isinstance(i, slice) and i == slice(None))
               for d, i in enumerate(index)):
        return False
    mesh, local = target.device_mesh, target._local_tensor
    dropped = [d for d, i in enumerate(index) if isinstance(i, int)]
    region_pl, local_index = [], list(index)
    for p in target.placements:
        if isinstance(p, Shard) and p.dim < len(index) and index[p.dim] != slice(None):
            region_pl.append(Replicate())
        elif isinstance(p, Shard):
            region_pl.append(Shard(p.dim - sum(d < p.dim for d in dropped)))
        else:
            region_pl.append(p)
    for d, i in enumerate(index):
        if d not in sharded or i == slice(None):
            continue
        n = local.shape[d]
        if isinstance(i, int):
            local_index[d] = (i % target.shape[d]) % n
            continue
        start, stop, step = i.indices(target.shape[d])
        if step != 1 or stop - start > n or (start % n) + (stop - start) > n:
            return False
        local_index[d] = slice(start % n, start % n + (stop - start))
    if not isinstance(value, DTensor):
        value = DTensor.from_local(torch.as_tensor(value, dtype=target.dtype,
                                                   device=local.device),
                                   mesh, [Replicate()] * mesh.ndim, run_check=False)
    region = value.redistribute(mesh, region_pl)
    local[tuple(local_index)] = region._local_tensor
    return True


def _on_locals(func, args, kwargs):
    """`func` on the local tensors of replicated DTensor inputs, each tensor
    output wrapped back as replicated on their mesh (an op DTensor has no
    strategy for at all)."""
    mesh = next(x.device_mesh for x in _tensors((args, kwargs)) if isinstance(x, DTensor))
    flat, spec = tree_flatten((args, kwargs))
    l_args, l_kwargs = tree_unflatten(
        [x._local_tensor if isinstance(x, DTensor) else x for x in flat], spec)
    out = func(*l_args, **l_kwargs)
    flat, spec = tree_flatten(out)
    return tree_unflatten(
        [DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)
         if isinstance(x, torch.Tensor) else x for x in flat], spec)


class _GlobalCounter(TorchDispatchMode):
    """Above DTensor: per-device FLOPs by the placement rule, and the
    replicated fallback where DTensor has no plan."""

    def __init__(self, totals: _Totals):
        super().__init__()
        self.t = totals

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if not any(issubclass(t, DTensor) for t in types):
            out = func(*args, **kwargs)
            self._count(func, args, kwargs, out, scale=1.0)
            return out
        t = self.t
        if _is_dot(func):
            args, kwargs = _reduced(args), _reduced(kwargs)
        sharded = _SHARDED_REDUCTIONS.get(func)
        try:
            if sharded is not None and _reduces_sharded_dim(args[0], args[1]):
                out = sharded(*args, **kwargs)
                t.sharded[str(func)] = t.sharded.get(str(func), 0.0) + t.mult
            elif func in _SPLITS and _split_keeps_shards(*args):
                out = self._sharded_split(*args)
                t.sharded[str(func)] = t.sharded.get(str(func), 0.0) + t.mult
            else:
                out = func(*args, **kwargs)
        except Exception as e:  # noqa: BLE001 - DTensor found no plan: replicate
            out = self._replicated(func, args, kwargs, e)
        outs = _tensors(out)
        if outs and isinstance(outs[0], DTensor):
            o = outs[0]
            scale = (o._local_tensor.numel() / max(1, o.numel())) / _partial_size(o)
        else:
            scale = 1.0
        self._count(func, args, kwargs, out, scale)
        return out

    def _sharded_split(self, x: DTensor, sizes, dim: int = 0) -> list:
        """Pieces of a split along a sharded dim, each left sharded as `x`
        is: every rank trades its shard for its share of each piece, one
        all-to-all of its shard (where DTensor would gather the whole dim)."""
        t, loc = self.t, x._local_tensor
        dim %= x.dim()
        sizes = _split_sizes(x.shape[dim], sizes)
        n = _shard_count(x, dim)
        payload = tensor_bytes(loc)
        t.coll_raw["all-to-all"] += t.mult * payload
        t.coll_n["all-to-all"] += t.mult
        t.bytes += t.mult * 2 * payload
        out = []
        for size in sizes:
            shape = list(loc.shape)
            shape[dim] = size // n
            out.append(DTensor.from_local(loc.new_empty(shape), x.device_mesh, x.placements,
                                          run_check=False))
        return out

    def _count(self, func, args, kwargs, out, scale: float) -> None:
        f = _op_flops(func, args, kwargs, out)
        if not f:
            return
        t = self.t
        t.flops += t.mult * f * scale
        o = _tensors(out)[0]
        local = o._local_tensor if isinstance(o, DTensor) else o
        t.dots[shape_key(local)] += t.mult * f * scale

    def _replicated(self, func, args, kwargs, err: Exception):
        """`func` on its DTensor inputs replicated over the fewest trailing
        mesh dims that give DTensor a plan (the model dim first, then every
        dim; a failed try's counts are dropped); with every dim replicated
        and still no strategy, on the local tensors.  An in-place op writes
        the result back into its first argument's shards.  Where nothing
        works, `err` is raised with the op and its inputs' placements."""
        t = self.t
        before = t.coll_bytes()
        flat, spec = tree_flatten((args, kwargs))
        ndim = next(x.device_mesh.ndim for x in flat if isinstance(x, DTensor))

        def rep(x, k):
            if not isinstance(x, DTensor):
                return x
            return x.redistribute(x.device_mesh, [Replicate() if d >= ndim - k else p
                                                  for d, p in enumerate(x.placements)])

        out = None
        for k in range(1, ndim + 2):
            snap = t.snapshot()
            try:
                r_args, r_kwargs = tree_unflatten([rep(x, min(k, ndim)) for x in flat], spec)
                out = (func(*r_args, **r_kwargs) if k <= ndim
                       else _on_locals(func, r_args, r_kwargs))
                break
            except Exception:  # noqa: BLE001 - no plan at this replication
                t.restore(snap)
        if out is None:
            err.add_note(f"dry run: {func} on " + ", ".join(
                f"{tuple(x.shape)} {x.placements}" for x in flat if isinstance(x, DTensor)))
            raise err
        self_arg = args[0] if args else None
        if _name(func).endswith("_") and isinstance(self_arg, DTensor):
            res = out.redistribute(self_arg.device_mesh, self_arg.placements)
            self_arg._local_tensor.copy_(res._local_tensor)
            out = self_arg
        rec = t.replicated.setdefault(str(func), {"count": 0.0, "bytes": 0.0})
        rec["count"] += t.mult
        rec["bytes"] += t.coll_bytes() - before
        return out


def _alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
    return torch.ops._dtensor.shard_dim_alltoall(
        input, gather_dim, shard_dim, mesh.get_group(mesh_dim).group_name)


@contextlib.contextmanager
def _asked_alltoall():
    """DTensor's all-to-all issued as the op it asks for, on any mesh: on
    a "cpu" DeviceMesh ``shard_dim_alltoall`` would gather and chunk
    instead, which a count would take for an all-gather."""
    from torch.distributed.tensor import placement_types

    prev = placement_types.shard_dim_alltoall
    placement_types.shard_dim_alltoall = _alltoall
    try:
        yield
    finally:
        placement_types.shard_dim_alltoall = prev


class TraceCounter:
    """The two modes over one set of totals.  Enter it around the step (the
    step's DTensors and fake shards made beforehand); `cost()` reads the
    totals as an `HloCost`."""

    def __init__(self, fake_mode=None) -> None:
        self.totals = _Totals()
        self.fake_mode = fake_mode
        self._stack: contextlib.ExitStack | None = None

    def __enter__(self) -> "TraceCounter":
        from torch.distributed.tensor.experimental import implicit_replication

        self._stack = contextlib.ExitStack()
        self._stack.enter_context(_asked_alltoall())
        self._stack.enter_context(_LocalCounter(self.totals, self.fake_mode))
        self._stack.enter_context(_GlobalCounter(self.totals))
        self._stack.enter_context(_ShardedFunctions(self.totals))
        self._stack.enter_context(implicit_replication())
        return self

    def __exit__(self, *exc) -> None:
        self._stack.close()
        self._stack = None

    @contextlib.contextmanager
    def trips(self, n: int):
        """Count what runs inside `n` times over."""
        t = self.totals
        prev, t.mult = t.mult, t.mult * n
        try:
            yield
        finally:
            t.mult = prev

    def scan(self, body: Callable[[int], Any], n: int) -> None:
        """A loop of `n` trips traced as its first trip, counted `n` times
        (the reference's while body times its trip count)."""
        with self.trips(n):
            body(0)

    def hold(self, tree) -> None:
        """Mark the storages of `tree`'s local tensors (the step's arguments,
        made before the trace) as not the trace's own."""
        for x in _tensors(tree):
            self.totals.held.add((x._local_tensor if isinstance(x, DTensor) else x)
                                 .untyped_storage()._cdata)

    def cost(self, *, argument_bytes: float = 0.0, output_bytes: float = 0.0,
             top: int | None = 12) -> HloCost:
        """The totals as an `HloCost`: the `top` dot shapes by FLOPs (None:
        every shape); the peak of live bytes is the arguments' and the
        peak of what the trace made."""
        t = self.totals
        return _cost(t.flops, t.bytes, dict(t.coll_raw), dict(t.coll_n), dict(t.dots), top,
                     replicated_ops={k: dict(v) for k, v in t.replicated.items()},
                     sharded_ops=dict(t.sharded), local_flops=t.local_flops,
                     argument_bytes=argument_bytes, output_bytes=output_bytes,
                     peak_live_bytes=argument_bytes + t.peak)


def _cost(flops, bytes_, coll_raw, coll_n, dots, top, **extra) -> HloCost:
    by_kind = {k: v * _TRAFFIC_FACTOR[k] for k, v in coll_raw.items()}
    ranked = sorted(dots.items(), key=lambda kv: -kv[1])
    return HloCost(
        flops=flops,
        bytes=bytes_,
        collective_bytes=sum(by_kind.values()),
        collective_by_kind=by_kind,
        collective_counts={k: int(round(v)) for k, v in coll_n.items()},
        dot_flops_by_shape=dict(ranked if top is None else ranked[:top]),
        collective_raw_by_kind=coll_raw,
        **extra)


def grows(c1: HloCost, c2: HloCost) -> bool:
    """Whether `c2` (one more block) counts at least `c1` in every figure."""
    pairs = [(c1.flops, c2.flops), (c1.bytes, c2.bytes)] + [
        (d1.get(k, 0.0), d2.get(k, 0.0))
        for d1, d2 in ((c1.collective_raw_by_kind, c2.collective_raw_by_kind),
                       (c1.collective_counts, c2.collective_counts))
        for k in {**d1, **d2}]
    return all(b >= a for a, b in pairs)


def extrapolate(c1: HloCost, c2: HloCost, m: float, top: int | None = 12) -> HloCost:
    """``c1 + m (c2 - c1)`` in every figure: the cost of a model ``m`` more
    blocks deep from traces one block apart (`c1` at depth k, `c2` at 2k,
    each with every dot shape), as the reference multiplies a scanned
    layer body by its trip count."""
    def num(a, b):
        return a + m * (b - a)

    def dmap(a: dict, b: dict) -> dict:
        return {k: num(a.get(k, 0.0), b.get(k, 0.0)) for k in {**a, **b}}

    rep = {k: dmap(c1.replicated_ops.get(k, {}), c2.replicated_ops.get(k, {}))
           for k in {**c1.replicated_ops, **c2.replicated_ops}}
    return _cost(num(c1.flops, c2.flops), num(c1.bytes, c2.bytes),
                 dmap(c1.collective_raw_by_kind, c2.collective_raw_by_kind),
                 dmap(c1.collective_counts, c2.collective_counts),
                 dmap(c1.dot_flops_by_shape, c2.dot_flops_by_shape), top,
                 replicated_ops=rep, sharded_ops=dmap(c1.sharded_ops, c2.sharded_ops),
                 local_flops=num(c1.local_flops, c2.local_flops),
                 argument_bytes=num(c1.argument_bytes, c2.argument_bytes),
                 output_bytes=num(c1.output_bytes, c2.output_bytes),
                 peak_live_bytes=(None if c1.peak_live_bytes is None or c2.peak_live_bytes is None
                                  else num(c1.peak_live_bytes, c2.peak_live_bytes)))


def local_bytes(tree) -> float:
    """Bytes of the local shards of every tensor in `tree`."""
    total = 0
    for x in _tensors(tree):
        total += (x._local_tensor if isinstance(x, DTensor) else x).numel() * x.element_size()
    return float(total)
