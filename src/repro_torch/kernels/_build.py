"""Build and load the port's CUDA kernels: nvcc into shared libraries with a
plain C interface, loaded with ctypes.

Each ``csrc/<name>.cu`` compiles to its own library under ``build/kernels``
at the repository root, all sources at once (one nvcc process each), the
first time a kernel is launched.  Libraries are named by a hash of their
sources and flags, so an edited source rebuilds and an unchanged one loads
from the previous build.  Nothing here runs at import time: the CPU tests
import every module, and this machine's CPU-only PyTorch has no nvcc.

Also here: :func:`pinned_empty`, the exact-size pinned, device-mapped host
allocation that holds the remote tier, and :func:`pinned_bytes`, what it
holds now.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import math
import os
import shutil
import subprocess
import weakref
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("splitk_gemm", "paged_flashattn", "splitk_flashattn", "flash_prefill",
           "host_mem")
MEASUREMENT_SOURCES = ("host_probe", "decode_attn_cpasync")   # on no path, built only when asked
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Error codes of csrc/dak_common.cuh (cudaError_t values are positive).
_DAK_ERRORS = {
    -1: "remote-tier pointer is not pinned host memory mapped into the device",
    -2: "shape or launch parameter the kernel does not take",
    -3: "the driver refused to encode a tensor map",
}

_P, _I = ctypes.c_void_p, ctypes.c_int
_LLP, _IP = ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int)
# The `*_smem` entries are queries: what a launch with those arguments would
# hold in shared memory (and its ring stages), by the launch's own arithmetic.
_SIGNATURES = {
    "splitk_gemm": {
        "dak_splitk_gemm": [_P] * 4 + [_I] * 6 + [_P, _P, _I, _P],
        "dak_splitk_gemm_grouped": [_P] * 4 + [_I] * 6 + [_P, _P, _I, _P],
        "dak_splitk_gemm_smem": [_I] * 5 + [_LLP, _IP],
    },
    "paged_flashattn": {
        "dak_paged_attention": [_P] * 9 + [_I] * 8 + [ctypes.c_float, _I, _I, _P],
        "dak_scatter_rows": [_P] * 5 + [_I] * 6 + [_P],
        "dak_paged_attention_smem": [_I] * 8 + [_LLP, _IP],
    },
    "splitk_flashattn": {
        "dak_splitk_attention": [_P] * 6 + [_I] * 9 + [_P],
        "dak_splitk_attention_smem": [_I] * 6 + [_LLP, _IP],
    },
    "flash_prefill": {
        "dak_flash_prefill": [_P] * 4 + [_I] * 8 + [_P],
        "dak_flash_prefill_fma": [_P] * 4 + [_I] * 8 + [_P],
        "dak_flash_prefill_smem": [_I, _I, _LLP],
    },
    "host_mem": {
        "dak_host_alloc": [ctypes.c_size_t, ctypes.POINTER(ctypes.c_void_p)],
        "dak_host_free": [_P],
        "dak_check_mapped": [_P],
    },
    "host_probe": {
        "dak_host_read_probe": [_P] + [_I] * 7 + [_P, _P],
    },
    "decode_attn_cpasync": {
        "dak_paged_attention_cpasync": [_P] * 9 + [_I] * 8 + [ctypes.c_float, _I, _I, _P],
        "dak_splitk_attention_cpasync": [_P] * 6 + [_I] * 9 + [_P],
    },
}


def build_dir() -> Path:
    """``build/kernels`` at the repository root (listed in .gitignore)."""
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").exists():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit (put nvcc on PATH or set CUDA_HOME)")


@dataclasses.dataclass
class KernelLibs:
    """The loaded kernel libraries and what ptxas reported for each."""

    libs: dict[str, ctypes.CDLL]     # source name -> library
    ptxas: dict[str, str]            # source name -> nvcc/ptxas output


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _build_all(names: tuple[str, ...]) -> KernelLibs:
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    targets = {name: out / f"{name}-{_digest(name)}.so" for name in names}
    procs = {}
    for name, so in targets.items():
        if so.exists():
            continue
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp)
    logs = {name: proc.communicate()[0] for name, (proc, _) in procs.items()}
    for name, (proc, tmp) in procs.items():
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}.cu:\n{logs[name]}")
        targets[name].with_suffix(".log").write_text(logs[name])
        os.replace(tmp, targets[name])
    libs, ptxas = {}, {}
    for name, so in targets.items():
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
        log = so.with_suffix(".log")
        ptxas[name] = log.read_text() if log.exists() else ""
    return KernelLibs(libs, ptxas)


_LOADED: dict[tuple[str, ...], KernelLibs] = {}


def _load(names: tuple[str, ...]) -> KernelLibs:
    if names not in _LOADED:
        if not torch.cuda.is_available():
            raise RuntimeError("the CUDA kernels need a CUDA device")
        _LOADED[names] = _build_all(names)
    return _LOADED[names]


def load() -> KernelLibs:
    """Build (if needed) and load the port's kernel libraries, once per process."""
    return _load(SOURCES)


def load_measurement() -> KernelLibs:
    """Build (if needed) and load the measurement kernels (``MEASUREMENT_SOURCES``),
    once per process; no path of the port runs them."""
    return _load(MEASUREMENT_SOURCES)


def check(rc: int, what: str) -> None:
    """Raise unless a C entry point returned 0."""
    if rc == 0:
        return
    if rc in _DAK_ERRORS:
        raise RuntimeError(f"{what}: {_DAK_ERRORS[rc]}")
    raise RuntimeError(
        f"{what}: CUDA error {rc} ({torch.cuda.cudart().cudaGetErrorString(rc)})")


def smem_query(source: str, entry: str, *args: int, stages: bool = True) -> tuple[int, int]:
    """Call a kernel library's shared-memory query entry: ``(bytes, ring
    stages)`` of the launch the integer arguments describe (stages 0 for an
    entry that reports none).  Needs the card, like every entry."""
    nbytes, n_stages = ctypes.c_longlong(0), ctypes.c_int(0)
    out = (ctypes.byref(nbytes), ctypes.byref(n_stages)) if stages else (ctypes.byref(nbytes),)
    check(getattr(load().libs[source], entry)(*args, *out), entry)
    return nbytes.value, n_stages.value


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


_PINNED = {"bytes": 0}      # bytes `pinned_empty` holds in this process


def pinned_bytes() -> int:
    """Bytes of pinned host memory that `pinned_empty` allocations hold now
    (freed ones excluded)."""
    return _PINNED["bytes"]


def _free_pinned(host: ctypes.CDLL, ptr: int, nbytes: int) -> None:
    host.dak_host_free(ptr)
    _PINNED["bytes"] -= nbytes


def pinned_empty(shape, dtype: torch.dtype) -> torch.Tensor:
    """An uninitialised CPU tensor in pinned host memory mapped into the
    device (cudaHostAlloc, mapped and portable), exactly as large as asked.

    The memory is freed when the last tensor viewing it is gone."""
    host = load().libs["host_mem"]
    n = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
    nbytes = max(n, 1)
    ptr = ctypes.c_void_p()
    check(host.dak_host_alloc(nbytes, ctypes.byref(ptr)),
          f"cudaHostAlloc of {nbytes} bytes ({nbytes / 1e9:.3f} GB) of pinned host memory, "
          f"with {_PINNED['bytes']} bytes already pinned")
    buf = (ctypes.c_uint8 * nbytes).from_address(ptr.value)
    _PINNED["bytes"] += nbytes
    weakref.finalize(buf, _free_pinned, host, ptr.value, nbytes).atexit = False
    return torch.frombuffer(buf, dtype=torch.uint8)[:n].view(dtype).view(tuple(shape))
