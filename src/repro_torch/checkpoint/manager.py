"""Async, integrity-checked checkpointing with placement on restore.

Counterpart of ``src/repro/checkpoint/manager.py``, with its on-disk layout:

    <dir>/step_<N>/
        manifest.json      tree structure, shapes, dtypes, sha256 per leaf
        leaf_<i:05d>.npy   one file per tree leaf, in flatten order

Leaves are listed in ``jax.tree_util``'s flatten order (sorted dict keys),
each under its keys joined by ``/``, so each package reads the other's
fp32 checkpoints.  A bfloat16 leaf is stored as its raw 16-bit words
(uint16) with ``"dtype": "bfloat16"`` in the manifest: numpy has no
bfloat16 without ``ml_dtypes``.  Writes go to ``.tmp_step_<N>`` and are
atomically renamed, so a preempted save never corrupts the latest
checkpoint.  ``save_async`` copies the tree to host memory at the call and
writes it from a thread; the train loop blocks only on the previous save.
Leaves are written, read and hashed by `WORKERS` threads at once (numpy's
file I/O and hashlib release the interpreter lock on large buffers).
"""
from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import os
import shutil
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any

import numpy as np
import torch

from repro_torch.tree import flatten, tree_map, unflatten

WORKERS = min(8, os.cpu_count() or 1)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host tensor as numpy; bfloat16 as its raw words."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_numpy(a: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(np.asarray(a, order="C").view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.asarray(a, order="C"))


def _dtype_name(t: torch.Tensor) -> str:
    if t.dtype == torch.bfloat16:
        return "bfloat16"
    return str(torch.empty(0, dtype=t.dtype).numpy().dtype)


def _host_snapshot(tree: Any) -> Any:
    """A copy of every leaf in host memory (the tree may change after)."""
    return tree_map(lambda t: t.detach().to("cpu", copy=True), tree)


@dataclasses.dataclass
class SaveResult:
    step: int
    path: Path
    seconds: float
    bytes: int


class _HashingWriter:
    """A binary file that hashes what is written to it, so a leaf's sha256
    needs no second read of the file."""

    def __init__(self, path: Path):
        self._fh = open(path, "wb")
        self.sha = hashlib.sha256()

    def write(self, data) -> int:
        self.sha.update(data)
        return self._fh.write(data)

    def close(self) -> None:
        self._fh.close()


class CheckpointManager:
    def __init__(self, directory: str | Path, keep_last: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep_last = keep_last
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self._last_result: SaveResult | None = None

    # ---------------- save ----------------
    def save(self, step: int, tree: Any, extra: dict | None = None) -> SaveResult:
        t0 = time.time()
        host_tree = tree_map(lambda t: t.detach().cpu(), tree)
        tmp = self.dir / f".tmp_step_{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest: dict[str, Any] = {"step": step, "leaves": {}, "extra": extra or {}}
        leaves = list(flatten(host_tree))
        names = [f"leaf_{i:05d}.npy" for i in range(len(leaves))]

        def write(name: str, leaf: torch.Tensor) -> str:
            out = _HashingWriter(tmp / name)
            try:
                np.save(out, _to_numpy(leaf.contiguous()))
            finally:
                out.close()
            return out.sha.hexdigest()

        with ThreadPoolExecutor(WORKERS) as pool:
            digests = list(pool.map(write, names, [leaf for _, leaf in leaves]))
        total = 0
        for (key, leaf), name, digest in zip(leaves, names, digests):
            manifest["leaves"][key] = {
                "file": name, "shape": list(leaf.shape),
                "dtype": _dtype_name(leaf), "sha256": digest,
            }
            total += leaf.numel() * leaf.element_size()
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
        final = self.dir / f"step_{step}"
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)                      # atomic publish
        self._gc()
        res = SaveResult(step, final, time.time() - t0, total)
        self._last_result = res
        return res

    def save_async(self, step: int, tree: Any, extra: dict | None = None) -> None:
        """Snapshot `tree` to host memory now and write it from a thread; a
        failed write raises from the next `wait` (or `save_async`)."""
        self.wait()
        host_tree = _host_snapshot(tree)

        def run() -> None:
            try:
                self.save(step, host_tree, extra)
            except BaseException as e:         # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    @property
    def last_result(self) -> SaveResult | None:
        """The last finished save (call `wait` first for an async one)."""
        return self._last_result

    def _gc(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep_last]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # ---------------- restore ----------------
    def all_steps(self) -> list[int]:
        return sorted(int(p.name.split("_")[1]) for p in self.dir.glob("step_*"))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(
        self,
        step: int | None,
        like: Any,
        device: str | torch.device | None = None,
        verify: bool = True,
    ) -> tuple[Any, dict]:
        """Restore into the structure of `like`, each leaf on `device` if
        given, else on the device of its leaf in `like` (the port's
        counterpart of the reference's `shardings`)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        path = self.dir / f"step_{step}"
        manifest = json.loads((path / "manifest.json").read_text())

        def read(key: str, leaf_like: Any) -> torch.Tensor:
            meta = manifest["leaves"][key]
            if verify:
                data = (path / meta["file"]).read_bytes()     # read once: hashed, then parsed
                if hashlib.sha256(data).hexdigest() != meta["sha256"]:
                    raise IOError(f"checkpoint corruption at leaf {key}")
                raw = np.load(io.BytesIO(data))
                del data
            else:
                raw = np.load(path / meta["file"])
            if list(raw.shape) != list(leaf_like.shape):
                raise ValueError(
                    f"shape mismatch for {key}: ckpt {raw.shape} vs {tuple(leaf_like.shape)}")
            t = _from_numpy(raw, meta["dtype"])
            return t.to(device if device is not None else leaf_like.device)

        pairs = list(flatten(like))
        with ThreadPoolExecutor(WORKERS) as pool:
            out = list(pool.map(read, [k for k, _ in pairs], [v for _, v in pairs]))
        tree = unflatten(like, iter(out))
        return tree, manifest.get("extra", {})
