"""The serving mesh: P ranks, one process each, over ``torch.distributed``.

Counterpart of ``src/repro/launch/mesh.py`` (`make_dev_mesh`, `data_axes`,
`axis_size`).  The reference drives every chip of its mesh from one
controller; here each rank is its own process (started by ``torchrun`` or
by :func:`run_ranks`, which spawns them), every rank runs the same engine
on the same requests, and ranks talk only through ``torch.distributed``.

`Mesh` is a small class of this module, not
``torch.distributed.device_mesh.DeviceMesh``: a DeviceMesh binds rank r to
device ``r % device_count`` and picks NCCL for CUDA devices, so it cannot
describe two ranks that share one card over gloo (the check the card's
one-device machine can run at P = 2), and the engine needs no more than a
process group per axis, this rank's index along it and a byte counter.

The backend is the caller's choice and nothing falls back: NCCL when each
rank has a card of its own (asking for it with more ranks than cards
raises), gloo for CPU ranks and for ranks that share one card.  NCCL with
P > 1 across cards is written but has not been run.

`make_production_mesh` is the dry run's (`launch/dryrun.py`): the
production 16 x 16 or 2 x 16 x 16 shape over a fake process group of 256
or 512 ranks, this process rank 0.  Its `Mesh` carries the DTensor
``DeviceMesh`` of the same grid (`Mesh.device_mesh`); no collective of a
fake group moves data, and nothing is allocated.
"""
from __future__ import annotations

import math
import os
from typing import Any, Callable

import torch
import torch.distributed as dist

BACKENDS = ("gloo", "nccl")


class Mesh:
    """A named grid of ranks: ``shape`` maps each axis to its size (row-major
    over the world's ranks, the last axis fastest), with one process group
    per axis holding this rank's line along it.

    ``link_bytes`` counts what this rank read from its own pinned host
    memory in fetch-once gathers (`kernels.ops.gather_shards`), by kind
    ("weights", "kv"); ``fetches`` counts the weight fetches; ``scratch``
    holds the gathers' staging buffers."""

    def __init__(self, axis_names: tuple[str, ...], sizes: tuple[int, ...], backend: str,
                 groups: dict[str, Any], index: dict[str, int]):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(axis_names, sizes))
        self.backend = backend
        self._groups = groups
        self._index = index
        self.link_bytes = {"weights": 0, "kv": 0}
        self.fetches = 0
        self.scratch: dict[tuple, torch.Tensor] = {}
        self.device_mesh = None           # a fake mesh's DTensor DeviceMesh

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def group(self, axis: str):
        """The process group of this rank's line along `axis`."""
        return self._groups[axis]

    def axis_index(self, axis: str) -> int:
        """This rank's index along `axis`."""
        return self._index[axis]

    def reset_counters(self) -> None:
        self.link_bytes = {"weights": 0, "kv": 0}
        self.fetches = 0

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, backend={self.backend!r})"


def check_backend(backend: str, world_size: int) -> None:
    """Refuse a backend the ranks cannot use: NCCL needs a card per rank (two
    ranks on one card must take gloo)."""
    if backend not in BACKENDS:
        raise ValueError(f"mesh backend must be one of {BACKENDS}, got {backend!r}")
    if backend == "nccl":
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if cards < world_size:
            raise RuntimeError(
                f"NCCL needs one card per rank: {world_size} ranks, {cards} card(s) on this "
                f"machine; ranks that share a card must use backend='gloo'")


def rank_device(backend: str, device: str | torch.device) -> torch.device:
    """The device this rank serves on: under NCCL its own card (the one
    `init_rank` made current), under gloo `device` as given (ranks may
    share one card)."""
    device = torch.device(device)
    if backend != "nccl":
        return device
    if device.type != "cuda":
        raise ValueError(f"NCCL ranks run on cards, got device {device}")
    return torch.device("cuda", torch.cuda.current_device())


def init_rank(rank: int, world_size: int, *, backend: str, init_method: str) -> None:
    """Join this process to the ranks' default process group; an NCCL rank
    first takes its own card (the local rank's).  Nothing on a machine says
    where the others are: ``init_method`` does (``file://PATH`` for ranks on
    one host, ``tcp://localhost:PORT``, or ``env://`` under torchrun)."""
    check_backend(backend, world_size)
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)


def make_dev_mesh(n_data: int = 1, n_model: int = 1) -> Mesh:
    """The ("data", "model") mesh over the ranks of the default process
    group, which must number ``n_data * n_model``.  Every rank calls it (the
    axis groups are made collectively).  Serving shards its remote tier on
    "model"; "data" lines replicate."""
    if not dist.is_initialized():
        raise RuntimeError("make_dev_mesh needs an initialised process group "
                           "(launch.mesh.init_rank, or torchrun)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_data * n_model != world:
        raise ValueError(f"a {n_data} x {n_model} mesh needs {n_data * n_model} ranks, "
                         f"the process group has {world}")
    backend = dist.get_backend()
    check_backend(backend, world)
    d, m = divmod(rank, n_model)
    groups: dict[str, Any] = {}
    for axis, lines in (("model", [[i * n_model + j for j in range(n_model)]
                                   for i in range(n_data)]),
                        ("data", [[i * n_model + j for i in range(n_data)]
                                  for j in range(n_model)])):
        if len(lines) == 1:
            groups[axis] = dist.group.WORLD
            continue
        for line in lines:                 # collective: every rank makes every line's group
            g = dist.new_group(ranks=line)
            if rank in line:
                groups[axis] = g
    return Mesh(("data", "model"), (n_data, n_model), backend, groups,
                {"data": d, "model": m})


def fake_mesh(sizes: tuple[int, ...], axis_names: tuple[str, ...]) -> Mesh:
    """A mesh of ``prod(sizes)`` ranks over a fake process group, this
    process rank 0: the default group is made (or remade, when a fake group
    of another size holds it), and the DTensor ``DeviceMesh`` of the grid
    is built over it (device type "cpu", where the dry run's fake shards
    live).  A group of another backend is left alone: making a fake mesh
    then raises.

    The batch axes ("pod", "data") are one dim of the DeviceMesh, named
    "pod.data": every spec and hint names them together (`data_axes`), an
    XLA collective over both is one collective, and DTensor's search over
    placements grows as a power of the mesh's rank (a 3-D mesh makes a
    train step's einsums take minutes)."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    world = math.prod(sizes)
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(f"a fake mesh needs the default process group, which holds a "
                               f"{dist.get_backend()!r} group")
        if dist.get_world_size() != world:
            dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
        _forget_meshes()
    shape = dict(zip(axis_names, sizes))
    batch = [a for a in axis_names if a in ("pod", "data")]
    dims = ([".".join(batch)] if batch else []) + [a for a in axis_names if a not in batch]
    dm = DeviceMesh("cpu", torch.arange(world).reshape(
        [math.prod(shape[a] for a in d.split(".")) for d in dims]), mesh_dim_names=tuple(dims))
    mesh = Mesh(axis_names, sizes, "fake",
                {a: dm.get_group(mesh_dim(dims, a)) for a in axis_names},
                {a: 0 for a in axis_names})
    mesh.device_mesh = dm
    return mesh


def _forget_meshes() -> None:
    """Drop DTensor's cached sharding plans: a plan keeps the DeviceMesh it
    was made on, and a mesh of a new group equals the old one of the same
    grid, so a cached plan would reach for the destroyed group's names."""
    from torch.distributed.tensor import _redistribute, debug

    for clear in (getattr(debug, "_clear_sharding_prop_cache", None),
                  getattr(_redistribute, "clear_redistribute_planner_cache", None),
                  getattr(getattr(_redistribute, "_gen_transform_infos", None),
                          "cache_clear", None)):
        if clear is not None:
            clear()


def mesh_dim(dim_names: tuple[str, ...], axis: str) -> int:
    """The DeviceMesh dim that carries mesh axis `axis` (a merged dim is
    named by its axes joined with ".")."""
    for i, name in enumerate(dim_names):
        if axis in name.split("."):
            return i
    raise ValueError(f"no DeviceMesh dim carries axis {axis!r}: {dim_names}")


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """Single pod: 16 x 16 = 256 ranks (data x model).  Multi-pod: 2 x 16 x
    16 = 512 ranks with a leading pure-DP "pod" axis."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return fake_mesh(shape, axes)


def data_axes(mesh: Mesh) -> tuple[str, ...]:
    """Axes used for batch/FSDP sharding (pod composes with data)."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def axis_size(mesh: Mesh, axes: tuple[str, ...] | str) -> int:
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


def _rank_main(rank: int, fn: Callable, world_size: int, backend: str, init_method: str,
               args: tuple) -> None:
    init_rank(rank, world_size, backend=backend, init_method=init_method)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def run_ranks(fn: Callable, world_size: int, *, backend: str, init_method: str,
              args: tuple = ()) -> None:
    """Run ``fn(rank, *args)`` in `world_size` spawned processes, each joined
    to the default process group first and leaving it at the end.  `fn`
    must be importable by the children (a module-level function).  Raises
    if any rank raises; returns when all are done."""
    check_backend(backend, world_size)
    import torch.multiprocessing as mp

    mp.spawn(_rank_main, args=(fn, world_size, backend, init_method, args),
             nprocs=world_size, join=True)
