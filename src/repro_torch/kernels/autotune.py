"""Shape-keyed autotuner for the port's direct-access kernels on Hopper.

Counterpart of ``src/repro/kernels/autotune.py``.  The CUDA kernels ship
one design choice per shape (the GEMM wrapper's `decode_k_split`, the
engine's in-flight ``window`` for every kernel), yet the card shows a
per-shape choice that nothing makes: split-K against whole K flips with
the host link's speed, and a deeper ring speeds one GEMM and slows
another.  This module sweeps the kernels' own runtime knobs for each

    (op, operand shape, dtype, offload-ratio bucket, hardware profile)

under the reference's deterministic extension of the paper's EB cost
model (a fixed issue cost per transfer on top of the bandwidth terms,
plus pipeline fill), counted over the port's transfers, and caches the
winner.  The candidates:

* ``splitk_gemm``: ``{"k_split": 0 | a multiple of DECODE_BK, "window":
  1..8}``: whole K, or the split-K design at the wrapper's default split,
  twice, four times or half of it (kept within ``[DECODE_BK, K]``), each
  at ring depths 1 to 8.  The SM count behind the default split comes
  from the profile (`splitk_gemm.sm_count`).
* ``paged_splitk_flashattn`` and ``splitk_flashattn``: ``{"slots": w}``
  for ``w`` in `SLOT_CANDIDATES`; as in the reference, the tuned value
  caps the step's window and never changes results.
* ``flash_prefill``: the one tile it is compiled with.

Candidates the kernel would clamp to the same ring are the same kernel:
each is counted once, at its smallest window.  Every candidate passes the
Hopper kernel lints (DAK101-103, `repro_torch.analysis.kernel_lints`)
before it may win.  The sweep is arithmetic only (no launch), so a table
reloaded with :meth:`Autotuner.load` reproduces its winners bit for bit.
The JSON table, its keys and `Entry` are the reference's.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any

from repro_torch.core.hardware import H100_SXM, SYSTEMS, HardwareSpec
from repro_torch.kernels import splitk_flashattn as A
from repro_torch.kernels import splitk_gemm as G

# Candidate in-flight slot counts for the attention kernels' K/V ring.
SLOT_CANDIDATES = (1, 2, 4, 8)
# Candidate ring depths of the GEMM designs (whole K caps its ring at 8).
WINDOW_CANDIDATES = tuple(range(1, G.MAX_WINDOW + 1))

# Fixed issue cost of one transfer (descriptor set-up and copy-engine or
# TMA turnaround), host link and HBM: modeled, not measured on any chip.
# They are what make the ring depth and the CTA count matter at all: pure
# bandwidth terms do not depend on either.
HOST_ISSUE_S = 2e-6
HBM_ISSUE_S = 0.5e-6

TABLE_VERSION = 1

Key = tuple  # (op, shape-tuple, dtype, ratio-bucket, hw-name)


def _ratio_bucket(n_loc: int, n_rem: int) -> float:
    """Offload ratio bucketed to one decimal (the key granularity)."""
    total = n_loc + n_rem
    return round(n_rem / total, 1) if total else 0.0


def dtype_name(dtype) -> str:
    """A dtype's key name: "float32", "bfloat16" (the reference's
    ``str(x.dtype)``), for a torch dtype or a name."""
    return str(dtype).removeprefix("torch.")


@dataclasses.dataclass(frozen=True)
class Entry:
    """One tuned winner: the config that won the sweep plus its modeled
    latency (microseconds) under the key's hardware profile."""
    op: str
    shape: tuple[int, ...]
    dtype: str
    ratio: float
    hw: str
    config: dict[str, int] | None      # None: no candidate survived the lints
    modeled_us: float

    def key(self) -> Key:
        return (self.op, tuple(self.shape), self.dtype, self.ratio, self.hw)

    def to_json(self) -> dict[str, Any]:
        return {"op": self.op, "shape": list(self.shape), "dtype": self.dtype,
                "ratio": self.ratio, "hw": self.hw, "config": self.config,
                "modeled_us": self.modeled_us}

    @classmethod
    def from_json(cls, d: dict[str, Any]) -> "Entry":
        return cls(op=d["op"], shape=tuple(int(s) for s in d["shape"]),
                   dtype=d["dtype"], ratio=float(d["ratio"]), hw=d["hw"],
                   config=(None if d.get("config") is None
                           else {k: int(v) for k, v in d["config"].items()}),
                   modeled_us=float(d["modeled_us"]))


class Autotuner:
    """Sweeps the kernels' runtime knobs under the EB cost model, lint-validated.

    ``sweep=False`` makes the tuner lookup-only: misses return ``None``
    (callers keep the kernels' own choices) instead of running a sweep,
    the mode ``--autotune-cache`` without ``--autotune`` uses to reproduce
    a table without growing it.  ``window`` is the ring depth the
    attention entries of a table are linted at when their config carries
    none."""

    def __init__(self, hw: HardwareSpec = H100_SXM, *, window: int = 2,
                 sweep: bool = True):
        self.hw = hw
        self.window = max(1, int(window))
        self.sweep = sweep
        self.table: dict[Key, Entry] = {}
        self.hits = 0
        self.misses = 0
        self.sweeps = 0

    # -- cache plumbing ----------------------------------------------------
    def _get(self, key: Key, sweep_fn) -> dict[str, int] | None:
        ent = self.table.get(key)
        if ent is not None:
            self.hits += 1
            return ent.config
        self.misses += 1
        if not self.sweep:
            return None
        self.sweeps += 1
        config, us = sweep_fn()
        self.table[key] = Entry(op=key[0], shape=key[1], dtype=key[2],
                                ratio=key[3], hw=key[4], config=config,
                                modeled_us=us)
        return config

    @staticmethod
    def _best(candidates) -> tuple[dict[str, int] | None, float]:
        """The cheapest (config, seconds) of an iterable; strict <, so ties
        go to the first (the smallest window)."""
        best, best_t = None, float("inf")
        for config, t in candidates:
            if t < best_t:
                best, best_t = config, t
        return best, (best_t * 1e6 if best is not None else 0.0)

    # -- lint guards (lazy import: analysis imports kernels, not vice versa)
    def _gemm_ok(self, m, k, n_loc, n_rem, k_split, window, db) -> bool:
        from repro_torch.analysis import kernel_lints as KL

        launch = KL.GemmLaunch(name="autotune", m=m, k=k, n_loc=n_loc, n_rem=n_rem,
                               k_split=k_split, window=window, dtype_bytes=db)
        return not KL.check_gemm_launch(launch, self.hw, where="autotune")

    def _attn_ok(self, kind, h, kh, hd, chunk, n_chunks, window, db) -> bool:
        from repro_torch.analysis import kernel_lints as KL

        launch = KL.AttnLaunch(name="autotune", kind=kind, h=h, kh=kh, hd=hd, chunk=chunk,
                               n_chunks=n_chunks, window=window, dtype_bytes=db)
        return not KL.check_attn_launch(launch, self.hw, where="autotune")

    def _prefill_ok(self, hd, tq, tk, bq, bk, db) -> bool:
        from repro_torch.analysis import kernel_lints as KL

        launch = KL.PrefillLaunch(name="autotune", hd=hd, tq=tq, tk=tk, block_q=bq,
                                  block_k=bk, dtype_bytes=db)
        return not KL.check_prefill_launch(launch, self.hw, where="autotune")

    # -- cost models (deterministic EB extensions) -------------------------
    def _gemm_cost(self, m, k, n_loc, n_rem, k_split, window, db) -> float:
        """max(host stream, HBM stream, compute) + pipeline fill.  Each
        stream pays an issue cost per transfer (one DECODE_BN x DECODE_BK
        TMA box per split-K load, one 32-row chunk per whole-K stage),
        amortized over the ring's stages and the CTAs of the tier that run
        at once (one per SM at most).  The split-K design adds its fp32
        partial sums, written and read back through HBM; whole K re-reads
        each weight once per M tile."""
        hw, sm = self.hw, G.sm_count(self.hw)
        stages, _ = G.ring_stages(m, k, window=window, k_split=k_split, dtype=db)
        if k_split > 0:
            splits, m_tiles = -(-k // k_split), 1
            partial_bytes = 2 * splits * m * (n_loc + n_rem) * 4 if splits > 1 else 0
        else:
            splits, m_tiles = 1, -(-m // G._whole_k_bm(m))
            partial_bytes = 0
        loads = -(-k // G.DECODE_BK)             # transfers a tile's CTAs issue, all splits
        rem_tiles, loc_tiles = -(-n_rem // G.DECODE_BN), -(-n_loc // G.DECODE_BN)
        rem_ctas, loc_ctas = rem_tiles * splits * m_tiles, loc_tiles * splits * m_tiles
        t_host = t_hbm_issue = 0.0
        if rem_ctas:
            t_host = (m_tiles * k * n_rem * db / hw.host.bandwidth
                      + rem_tiles * m_tiles * loads * HOST_ISSUE_S
                      / (stages * min(rem_ctas, sm)))
        if loc_ctas:
            t_hbm_issue = (loc_tiles * m_tiles * loads * HBM_ISSUE_S
                           / (stages * min(loc_ctas, sm)))
        t_hbm = ((m_tiles * k * n_loc + m * k + m * (n_loc + n_rem)) * db + partial_bytes) \
            / hw.hbm.bandwidth + t_hbm_issue
        t_compute = 2.0 * m * k * (n_loc + n_rem) / hw.peak_flops
        fill = stages * (HOST_ISSUE_S if rem_ctas else HBM_ISSUE_S)
        return max(t_host, t_hbm, t_compute) + fill

    def _attn_cost(self, h, kh, hd, chunk, n_chunks, b_rem_frac, db, window) -> float:
        """Streamed K/V chunks, split across tiers by the remote fraction:
        two boxes (K and V) per page or chunk, their issue cost amortized
        over the loads the ring keeps in flight (its stages less the one
        being folded in)."""
        hw = self.hw
        box = A._box_bytes(chunk, hd, db)
        stages, _ = A.ring_stages(window, 2 * box, n_chunks)
        inflight = max(1, stages - 1)
        kv_bytes = 2.0 * n_chunks * chunk * kh * hd * db
        rem = kv_bytes * b_rem_frac
        loc = kv_bytes - rem
        rem_xfers = max(1, round(n_chunks * b_rem_frac)) * 2
        t_host = rem / hw.host.bandwidth + rem_xfers * HOST_ISSUE_S / inflight
        t_hbm = loc / hw.hbm.bandwidth + 2 * n_chunks * HBM_ISSUE_S / inflight
        t_compute = 4.0 * n_chunks * chunk * h * hd / hw.peak_flops
        fill = min(stages, n_chunks) * HOST_ISSUE_S
        return max(t_host, t_hbm, t_compute) + fill

    def _prefill_cost(self, hd, tq, tk, bq, bk, db) -> float:
        hw = self.hw
        q_tiles, k_tiles = -(-tq // bq), -(-tk // bk)
        tqp, tkp = q_tiles * bq, k_tiles * bk
        bytes_streamed = (tqp * hd + q_tiles * 2 * tkp * hd + tqp * hd) * db
        t_hbm = bytes_streamed / hw.hbm.bandwidth + q_tiles * k_tiles * HBM_ISSUE_S
        t_compute = 4.0 * tqp * tkp * hd / hw.peak_flops
        return max(t_hbm, t_compute)

    # -- candidates ----------------------------------------------------------
    def gemm_k_splits(self, m: int, k: int, n_loc: int, n_rem: int, db: int) -> list[int]:
        """The GEMM's design candidates: 0 (whole K), then, where the
        split-K design takes the extents, the wrapper's default split, its
        half, double and quadruple, each a multiple of DECODE_BK within
        ``[DECODE_BK, K]`` (K rounded up to DECODE_BK: one split)."""
        out = [0]
        if G.decode_shapes_ok(m, k, n_loc, n_rem, db):
            base = G.decode_k_split(n_loc, n_rem, k, G.sm_count(self.hw))
            top = -(-k // G.DECODE_BK) * G.DECODE_BK
            for ks in (base, base // 2, base * 2, base * 4):
                ks = min(max(G.DECODE_BK, ks // G.DECODE_BK * G.DECODE_BK), top)
                if ks not in out:
                    out.append(ks)
        return out

    # -- per-op sweeps -----------------------------------------------------
    def best_gemm(self, m: int, k: int, n_loc: int, n_rem: int,
                  dtype: str = "float32") -> dict[str, int] | None:
        """Winning ``{"k_split", "window"}`` for one splitk_gemm shape, or
        None when one tier is empty or no candidate passes the lints
        (callers keep the wrapper's own choice)."""
        if n_loc <= 0 or n_rem <= 0:
            return None
        key = ("splitk_gemm", (m, k, n_loc, n_rem), dtype,
               _ratio_bucket(n_loc, n_rem), self.hw.name)

        def sweep():
            db = G.elem_bytes(dtype)

            def candidates():
                for ks in self.gemm_k_splits(m, k, n_loc, n_rem, db):
                    seen = set()
                    for w in WINDOW_CANDIDATES:
                        stages, _ = G.ring_stages(m, k, window=w, k_split=ks,
                                                  dtype=dtype)
                        if stages in seen:
                            continue            # the kernel clamps it to a ring already seen
                        seen.add(stages)
                        if self._gemm_ok(m, k, n_loc, n_rem, ks, w, db):
                            yield ({"k_split": ks, "window": w},
                                   self._gemm_cost(m, k, n_loc, n_rem, ks, w, db))

            return self._best(candidates())

        return self._get(key, sweep)

    def _slots_sweep(self, kind, h, kh, hd, chunk, n_chunks, rem_frac, dtype):
        db = G.elem_bytes(dtype)
        box = A._box_bytes(chunk, hd, db)

        def candidates():
            seen = set()
            for slots in SLOT_CANDIDATES:
                stages, _ = A.ring_stages(slots, 2 * box, n_chunks)
                if stages in seen:
                    continue
                seen.add(stages)
                if self._attn_ok(kind, h, kh, hd, chunk, n_chunks, slots, db):
                    yield ({"slots": slots},
                           self._attn_cost(h, kh, hd, chunk, n_chunks, rem_frac, db, slots))

        return self._best(candidates())

    def best_attn(self, h: int, kh: int, hd: int, s: int,
                  b_rem_frac: float = 0.5,
                  dtype: str = "float32") -> dict[str, int] | None:
        """Winning in-flight slot count for one batch-split splitk_flashattn
        shape (S positions in chunks of CHUNK rows)."""
        key = ("splitk_flashattn", (h, kh, hd, s), dtype,
               round(b_rem_frac, 1), self.hw.name)
        return self._get(key, lambda: self._slots_sweep(
            "batch", h, kh, hd, A.CHUNK, max(1, -(-s // A.CHUNK)), b_rem_frac, dtype))

    def best_paged(self, h: int, kh: int, hd: int, page_size: int,
                   max_pages: int, rem_frac: float = 0.5,
                   dtype: str = "float32") -> dict[str, int] | None:
        """Winning in-flight slot count for paged_splitk_flashattn (the
        chunk shape is the page size; only the ring depth is free)."""
        key = ("paged_splitk_flashattn", (h, kh, hd, page_size, max_pages),
               dtype, round(rem_frac, 1), self.hw.name)
        return self._get(key, lambda: self._slots_sweep(
            "paged", h, kh, hd, page_size, max_pages, rem_frac, dtype))

    def best_prefill(self, hd: int, tq: int, tk: int,
                     dtype: str = "float32") -> dict[str, int] | None:
        """The ``(block_q, block_k)`` flash_prefill is compiled with for
        ``dtype``, once it passes the lints: its tiles are fixed."""
        key = ("flash_prefill", (hd, tq, tk), dtype, 0.0, self.hw.name)

        def sweep():
            from repro_torch.kernels.flash_prefill import tiles

            db = G.elem_bytes(dtype)
            bq, bk = tiles(dtype)
            if not self._prefill_ok(hd, tq, tk, bq, bk, db):
                return None, 0.0
            return self._best([({"block_q": bq, "block_k": bk},
                                 self._prefill_cost(hd, tq, tk, bq, bk, db))])

        return self._get(key, sweep)

    # -- persistence -------------------------------------------------------
    def save(self, path: str) -> None:
        """Write the in-process table as a JSON cache (sorted keys so the
        file is byte-stable across runs with the same winners)."""
        entries = sorted((e.to_json() for e in self.table.values()),
                         key=lambda d: (d["op"], d["shape"], d["dtype"],
                                        d["ratio"], d["hw"]))
        with open(path, "w") as fh:
            json.dump({"version": TABLE_VERSION, "entries": entries}, fh,
                      indent=2)
            fh.write("\n")

    def load_table(self, path: str) -> int:
        """Merge a JSON cache into the in-process table; returns the number
        of entries loaded.  Loaded winners are served as cache hits: the
        sweep never reruns for a keyed shape, which is what makes a kept
        table reproducible."""
        with open(path) as fh:
            data = json.load(fh)
        if data.get("version") != TABLE_VERSION:
            raise ValueError(
                f"autotune table version {data.get('version')!r} "
                f"(want {TABLE_VERSION}) in {path}")
        n = 0
        for d in data["entries"]:
            ent = Entry.from_json(d)
            self.table[ent.key()] = ent
            n += 1
        return n

    @classmethod
    def load(cls, path: str, hw: HardwareSpec | None = None, *,
             window: int = 2, sweep: bool = True) -> "Autotuner":
        """Build a tuner seeded from a JSON cache.  ``hw`` defaults to the
        profile named by the table's entries (a table written by
        :meth:`save` holds one profile unless merged by hand)."""
        tuner = cls(hw or H100_SXM, window=window, sweep=sweep)
        tuner.load_table(path)
        if hw is None:
            names = {e.hw for e in tuner.table.values()}
            if len(names) == 1:
                name = next(iter(names))
                if name in SYSTEMS:
                    tuner.hw = SYSTEMS[name]
        return tuner

    # -- validation --------------------------------------------------------
    def validate(self, hw: HardwareSpec | None = None) -> list:
        """Re-lint every cached winner (DAK101-103) against ``hw`` (default:
        each entry's own profile).  Returns findings: empty means every
        tuned launch respects the kernels' shared-memory and TMA rules."""
        from repro_torch.analysis.kernel_lints import check_autotune_table

        return check_autotune_table(
            [e.to_json() for e in self.table.values()], hw,
            where="autotune", default_window=self.window)

    def counters(self) -> dict[str, int]:
        return {"entries": len(self.table), "hits": self.hits,
                "misses": self.misses, "sweeps": self.sweeps}


class RecordedLookups:
    """A tuner as one compiled decode step sees it.  Until :meth:`seal`,
    lookups go to the tuner (and count there) and are recorded; after it,
    a recorded lookup is answered from the record without touching the
    tuner.  The engine seals a bucket's view after its first run, so a
    captured graph's later runs (and the capture itself) count no hit, as
    a jitted step's calls do not retrace the reference's tuner."""

    def __init__(self, tuner: Autotuner):
        self.tuner = tuner
        self._record: dict[tuple, Any] = {}
        self._sealed = False

    def seal(self) -> None:
        self._sealed = True

    def _ask(self, name: str, *args) -> dict[str, int] | None:
        key = (name, args)
        if self._sealed and key in self._record:
            return self._record[key]
        out = self._record[key] = getattr(self.tuner, name)(*args)
        return out

    def best_gemm(self, *args) -> dict[str, int] | None:
        return self._ask("best_gemm", *args)

    def best_attn(self, *args) -> dict[str, int] | None:
        return self._ask("best_attn", *args)

    def best_paged(self, *args) -> dict[str, int] | None:
        return self._ask("best_paged", *args)

    def best_prefill(self, *args) -> dict[str, int] | None:
        return self._ask("best_prefill", *args)
