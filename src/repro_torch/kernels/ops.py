"""The compute ops the serving engine calls around the direct-access kernels.

`tiered_matmul`, `tiered_decode_attention` and `paged_decode_attention` are
the port's counterparts of ``src/repro/kernels/ops.py``: they normalise the
window (an int >= 1; it paces the kernel's copies and never changes
results) and reshape around the kernel wrappers.  Unlike the reference they
neither pad to block multiples nor fall back to the oracle for an empty
tier or a cache length that is not a multiple of a block: the CUDA
kernels mask ragged edges themselves and take an empty tier, so every
tiered operand on the card goes through a kernel.  On a CPU tensor the wrappers
compute the plain version.

Each op takes an optional ``tuner`` (`kernels.autotune.Autotuner`) and asks
it for this shape's winner, as the reference's ops do, on the card and on
the CPU alike (where the plain versions ignore the knobs, so the keys a
CPU run collects are the card's): a tuned GEMM runs its ``k_split`` and
``window``; a tuned attention's ``slots`` cap the step's window.

`broadcast_remote` and `mesh_fetch_params` are the fetch stage of mesh
serving (paper §4.3.2 fetch-once): each rank holds a disjoint 1/P slice of
every sharded host partition (`launch.sharding`), copies it up its own host
link once (`gather_shards`, which counts the bytes on the mesh), and one
all-gather over the mesh's process group fills the operand's fixed device
buffer with the whole remote tier, which the kernels then read in place of
pinned memory.  Only the remote tier crosses the mesh.  The all-gather
runs on ``torch.distributed`` (NCCL, or gloo through host memory) outside
any captured graph; a failed gather raises.
"""
from __future__ import annotations

import math

import torch

import torch.distributed as dist

from repro_torch.core.tiering import TieredTensor
from repro_torch.distributed.collectives import single_tensor_collective
from repro_torch.kernels.autotune import dtype_name
from repro_torch.kernels.sink import direct_access
from repro_torch.kernels.splitk_flashattn import paged_splitk_flashattn, splitk_flashattn
from repro_torch.kernels.splitk_gemm import splitk_gemm


def tiered_matmul(
    x: torch.Tensor,                                   # [..., K]
    w: TieredTensor,                                   # column-split [K, N]
    *,
    window: int = 2,
    tuner=None,
) -> torch.Tensor:
    """y = x @ W with W column-partitioned across (HBM, host) tiers.  With a
    ``tuner`` holding (or sweeping) a winner for this shape, the winner's
    design (``k_split``) and ring depth replace the wrapper's choice and
    the step's window."""
    window = max(1, int(window))
    lead = x.shape[:-1]
    k = x.shape[-1]
    n_loc, n_rem = w.local.shape[1], w.remote.shape[1]
    k_split = None
    if tuner is not None and n_loc and n_rem:
        tuned = tuner.best_gemm(math.prod(lead), k, n_loc, n_rem, dtype_name(x.dtype))
        if tuned is not None:
            k_split, window = tuned["k_split"], tuned["window"]
    y = splitk_gemm(x.reshape(-1, k).contiguous(), w.local, w.remote, window=window,
                    k_split=k_split)
    return y.reshape(*lead, y.shape[-1])


def tiered_decode_attention(
    q: torch.Tensor,                     # [B, H, hd]
    kv: dict[str, torch.Tensor],         # k_local/v_local [B_loc,S,Kh,hd], k_remote/v_remote
    *,
    kv_len: int,
    window: int = 2,
    tuner=None,
) -> torch.Tensor:
    """Batch-split tiered decode attention over positions [0, kv_len):
    requests [0, B_loc) read the local cache, [B_loc, B) the remote one.
    A ``tuner`` caps the window at its tuned slots for the cache's shape."""
    window = max(1, int(window))
    kl, kr = kv["k_local"], kv["k_remote"]
    s = kl.shape[1]
    if tuner is not None and s:
        b_total = kl.shape[0] + kr.shape[0]
        rem_frac = kr.shape[0] / b_total if b_total else 0.0
        tuned = tuner.best_attn(q.shape[1], kl.shape[2], kl.shape[3], s, rem_frac,
                                dtype_name(q.dtype))
        if tuned is not None:
            window = max(1, min(window, tuned["slots"]))
    return splitk_flashattn(
        q.contiguous(), kv["k_local"], kv["v_local"], kv["k_remote"], kv["v_remote"],
        kv_len=int(kv_len), window=window)


def paged_decode_attention(
    q: torch.Tensor,                     # [B, H, hd]
    pools: dict[str, torch.Tensor],      # k_local/v_local [P_loc+1,page,Kh,hd], k_remote/v_remote
    table: torch.Tensor,                 # [B, MP] int32 — page index in its tier pool
    tier: torch.Tensor,                  # [B, MP] int32 — 0 local / 1 remote
    lens: torch.Tensor,                  # [B] int32 — valid tokens per slot (ragged)
    *,
    window: int = 2,
    scale: float | None = None,
    tuner=None,
) -> torch.Tensor:
    """Ragged paged tiered decode attention (per-slot kv lengths; each page
    read from the tier its page-table entry names).  ``scale`` overrides
    the ``hd**-0.5`` softmax scale.  A ``tuner`` caps the window at its
    tuned slots for the pools' shape (the page size fixes the chunk; only
    the ring depth is tunable, and it never changes results)."""
    window = max(1, int(window))
    kl, kr = pools["k_local"], pools["k_remote"]
    if tuner is not None:
        n_pages = kl.shape[0] + kr.shape[0]
        rem_frac = kr.shape[0] / n_pages if n_pages else 0.0
        tuned = tuner.best_paged(q.shape[1], kl.shape[2], kl.shape[3], kl.shape[1],
                                 table.shape[1], rem_frac, dtype_name(q.dtype))
        if tuned is not None:
            window = max(1, min(window, tuned["slots"]))
    return paged_splitk_flashattn(
        q.contiguous(), pools["k_local"], pools["v_local"], pools["k_remote"],
        pools["v_remote"], table, tier, lens, window=window, scale=scale)


def _scratch(mesh, numel: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A flat buffer of at least `numel` elements kept on the mesh for its
    gathers (one per dtype and device, grown on demand, never shrunk)."""
    buf = mesh.scratch.get((dtype, device))
    if buf is None or buf.numel() < numel:
        buf = mesh.scratch[(dtype, device)] = torch.empty(numel, dtype=dtype, device=device)
    return buf[:numel]


@direct_access(lambda mesh, axis_name, shard, out, axis, **_: out)
def gather_shards(mesh, axis_name: str, shard: torch.Tensor, out: torch.Tensor, axis: int,
                  *, kind: str = "weights") -> torch.Tensor:
    """Fill `out` (the whole extent, on its device) with every rank's slice
    of it along `axis`: this rank's `shard` (its host slice) is copied up
    its own host link once, counted in ``mesh.link_bytes[kind]``, and one
    all-gather over the axis's process group shares the slices.  Returns
    `out`."""
    p = mesh.shape[axis_name]
    ax = axis % out.ndim
    want = list(out.shape)
    want[ax] //= p
    if list(shard.shape) != want or out.shape[ax] % p or shard.dtype != out.dtype:
        raise ValueError(f"a {p}-way gather along axis {ax} into {tuple(out.shape)} "
                         f"{out.dtype} takes slices of {tuple(want)}, got "
                         f"{tuple(shard.shape)} {shard.dtype}")
    n, rank = shard.numel(), mesh.axis_index(axis_name)
    # [p, *slice]: rank i's slice at index i, a view of `out` itself
    target = out.unflatten(ax, (p, shard.shape[ax])).movedim(ax, 0)
    direct = target.is_contiguous()
    in_place = mesh.backend == "nccl"     # NCCL gathers in place; gloo takes its own input
    need = (0 if direct else n * p) + (0 if in_place else n)
    buf = _scratch(mesh, need, out.dtype, out.device) if need else None
    staging = out.view(-1) if direct else buf[:n * p]
    mine = staging[rank * n:(rank + 1) * n] if in_place else buf[need - n:]
    mine.view(shard.shape).copy_(shard, non_blocking=True)     # the host-link read
    mesh.link_bytes[kind] += shard.nbytes
    if in_place:
        gather = single_tensor_collective("all_gather_single", "all_gather_into_tensor")
        gather(staging, mine, group=mesh.group(axis_name))
    else:
        dist.all_gather(list(staging.view(p, n).unbind(0)), mine, group=mesh.group(axis_name))
    if not direct:
        target.copy_(staging.view(target.shape))
    return out


def broadcast_remote(w: TieredTensor, mesh, axis_name: str) -> TieredTensor:
    """Fetch-once broadcast of one mesh-sharded operand: this rank's slice
    goes up its own host link and one all-gather rebuilds the whole remote
    tier in the operand's fixed device buffer, so each byte crossed a host
    link exactly once (read amplification 1x, paper §4.3.2).  Returns the
    operand with its remote tier whole (``mesh_axes=None``), which the
    compute ops consume exactly as on one rank."""
    gather_shards(mesh, axis_name, w.shard, w.remote, w.axis)
    return TieredTensor(w.local, w.remote, axis=w.axis)


def mesh_fetch_params(params, mesh, axis_name: str):
    """Fetch-once broadcast of every mesh-sharded remote partition in a
    params tree (one all-gather per operand); returns the tree with those
    leaves whole.  A tree with no leaf sharded on `axis_name` (offload 0, or
    no mesh) comes back as it is."""
    fetched = [False]

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, TieredTensor) and node.mesh_axes == axis_name:
            fetched[0] = True
            return broadcast_remote(node, mesh, axis_name)
        return node

    out = walk(params)
    if not fetched[0]:
        return params
    mesh.fetches += 1
    return out
