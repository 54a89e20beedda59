"""Trace-driven workload harness: synthetic generators + a replay format.

The serving benchmarks used to drive the engine with a fixed loop of
identical requests; this module produces *named scenarios* instead:

* :func:`poisson_trace` — open-loop Poisson arrivals with lognormal
  prompt/output lengths, split across tenant classes (each with its own
  priority, TTFT SLO and traffic share);
* :func:`bursty_trace` — the same marginals but arrivals clustered into
  bursts (every burst lands at one instant), the adversarial case for
  whole-prompt prefill;
* :data:`SCENARIOS` — the named presets the benchmark harness replays.

A :class:`Trace` is a plain JSON document (version header + one record
per request) so benchmark scenarios are checked in and replayed
bit-identically: prompt token ids are derived deterministically from
``(seed, rid)``, never stored.  Replay runs on the engine's modeled
clock — arrival times are virtual seconds — so two schedulers replaying
the same trace see exactly the same offered load.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np

TRACE_VERSION = 1


@dataclasses.dataclass(frozen=True)
class TenantClass:
    """One tenant / priority class of a synthetic workload."""

    name: str
    priority: int = 0
    slo_ttft_s: float | None = None      # TTFT SLO (None = best effort)
    share: float = 1.0                   # relative traffic share
    prompt_scale: float = 1.0            # class prompt-length multiplier
    # (interactive chat runs short prompts, batch/summarization long ones —
    #  the skew that makes chunked prefill matter)


@dataclasses.dataclass(frozen=True)
class TraceEntry:
    """One request of a trace (prompt ids derived from the trace seed)."""

    rid: int
    arrival_s: float                     # virtual seconds from trace start
    prompt_len: int
    max_new_tokens: int
    cls: str = "default"
    priority: int = 0
    slo_ttft_s: float | None = None


@dataclasses.dataclass
class Trace:
    entries: list[TraceEntry]
    seed: int = 0                        # prompt-token derivation seed
    description: str = ""

    # -- serialization -----------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "version": TRACE_VERSION,
            "description": self.description,
            "seed": self.seed,
            "requests": [dataclasses.asdict(e) for e in self.entries],
        }

    def save(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump(self.to_dict(), fh, indent=1)
            fh.write("\n")

    @classmethod
    def from_dict(cls, doc: dict) -> "Trace":
        ver = doc.get("version")
        if ver != TRACE_VERSION:
            raise ValueError(f"unsupported trace version {ver!r} "
                             f"(expected {TRACE_VERSION})")
        entries = [TraceEntry(**rec) for rec in doc["requests"]]
        return cls(entries=entries, seed=int(doc.get("seed", 0)),
                   description=doc.get("description", ""))

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path) as fh:
            return cls.from_dict(json.load(fh))

    # -- replay ------------------------------------------------------------
    def prompt_tokens(self, entry: TraceEntry, vocab: int) -> np.ndarray:
        """Deterministic prompt ids for one entry: a function of
        ``(trace seed, rid)`` only, so every scheduler / engine replaying
        the trace decodes the same prompts."""
        rng = np.random.default_rng((self.seed, entry.rid))
        return rng.integers(3, vocab, entry.prompt_len).astype(np.int32)

    def to_requests(self, vocab: int, request_cls=None) -> list:
        """Materialize engine `Request` objects (prompts derived from the
        seed; arrival/class/SLO metadata carried through)."""
        if request_cls is None:
            from repro_torch.serving.engine import Request as request_cls
        return [
            request_cls(
                rid=e.rid,
                prompt=self.prompt_tokens(e, vocab),
                max_new_tokens=e.max_new_tokens,
                cls=e.cls,
                priority=e.priority,
                arrival_s=e.arrival_s,
                slo_ttft_s=e.slo_ttft_s,
            )
            for e in self.entries
        ]


# ---------------------------------------------------------------------------
# Synthetic generators
# ---------------------------------------------------------------------------
DEFAULT_CLASSES = (
    TenantClass("batch", priority=0, slo_ttft_s=None, share=0.75),
    TenantClass("interactive", priority=2, slo_ttft_s=0.5, share=0.25),
)


def _lengths(rng: np.random.Generator, n: int, mu: float, sigma: float,
             lo: int, hi: int) -> np.ndarray:
    """Lognormal lengths clipped to [lo, hi] (production length mixes are
    heavy-tailed; the clip keeps smoke models inside max_len)."""
    raw = rng.lognormal(mean=mu, sigma=sigma, size=n)
    return np.clip(np.round(raw), lo, hi).astype(int)


def _assign_classes(rng: np.random.Generator, n: int,
                    classes: tuple[TenantClass, ...]) -> list[TenantClass]:
    shares = np.array([max(c.share, 0.0) for c in classes], dtype=float)
    if shares.sum() <= 0:
        raise ValueError("tenant class shares must sum to > 0")
    idx = rng.choice(len(classes), size=n, p=shares / shares.sum())
    return [classes[i] for i in idx]


def poisson_trace(
    n_requests: int,
    *,
    rate_rps: float = 4.0,
    prompt_mu: float = 2.6,
    prompt_sigma: float = 0.5,
    prompt_max: int = 48,
    out_mu: float = 1.6,
    out_sigma: float = 0.4,
    out_max: int = 12,
    classes: tuple[TenantClass, ...] = DEFAULT_CLASSES,
    seed: int = 0,
    description: str = "",
) -> Trace:
    """Open-loop Poisson arrivals (exponential gaps at ``rate_rps``) with
    lognormal prompt/output lengths and tenant classes drawn by share."""
    if n_requests < 1:
        raise ValueError("need at least one request")
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate_rps, size=n_requests)
    gaps[0] = 0.0
    arrivals = np.cumsum(gaps)
    plens = _lengths(rng, n_requests, prompt_mu, prompt_sigma, 2, prompt_max)
    olens = _lengths(rng, n_requests, out_mu, out_sigma, 1, out_max)
    assigned = _assign_classes(rng, n_requests, classes)
    entries = [
        TraceEntry(rid=i, arrival_s=float(arrivals[i]),
                   prompt_len=int(np.clip(round(plens[i] * c.prompt_scale),
                                          2, prompt_max)),
                   max_new_tokens=int(olens[i]),
                   cls=c.name, priority=c.priority, slo_ttft_s=c.slo_ttft_s)
        for i, c in enumerate(assigned)
    ]
    return Trace(entries=entries, seed=seed,
                 description=description or f"poisson rate={rate_rps}rps "
                 f"n={n_requests}")


def bursty_trace(
    n_requests: int,
    *,
    burst_size: int = 4,
    burst_gap_s: float = 1.0,
    classes: tuple[TenantClass, ...] = DEFAULT_CLASSES,
    seed: int = 0,
    description: str = "",
    **length_kw,
) -> Trace:
    """Bursty arrivals: requests land in bursts of ``burst_size`` at one
    instant, bursts separated by ``burst_gap_s`` — the adversarial case
    for whole-prompt FCFS prefill (a long batch prompt at the head of a
    burst blocks every interactive request behind it)."""
    base = poisson_trace(n_requests, classes=classes, seed=seed, **length_kw)
    entries = [
        dataclasses.replace(e, arrival_s=(i // burst_size) * burst_gap_s)
        for i, e in enumerate(base.entries)
    ]
    return Trace(entries=entries, seed=seed,
                 description=description or f"bursty size={burst_size} "
                 f"gap={burst_gap_s}s n={n_requests}")


def long_prompt_trace(n_requests: int, *, seed: int = 0, **kw) -> Trace:
    """Long-prompt-heavy mix: the prompt length distribution shifted up
    (chunked prefill's best case)."""
    kw.setdefault("prompt_mu", 3.4)
    kw.setdefault("prompt_sigma", 0.3)
    kw.setdefault("rate_rps", 2.0)
    return poisson_trace(n_requests, seed=seed,
                         description=f"long-prompt-heavy n={n_requests}", **kw)


# Named presets the benchmark harness replays (benchmarks/serving_bench.py
# calls `scenario_trace` — this is the single definition, so tuning a
# scenario here changes what CI measures).  Sized for smoke models on the
# modeled clock: step latencies are ~10 µs, so µs-scale arrival gaps are
# what makes the queue actually build.
_SCENARIO_CLASSES = (
    TenantClass("batch", priority=0, slo_ttft_s=None, share=0.7),
    TenantClass("interactive", priority=2, slo_ttft_s=6e-5, share=0.3),
)

SCENARIOS: dict[str, dict] = {
    "steady": {"factory": poisson_trace, "n_requests": 10,
               "kwargs": {"rate_rps": 150_000.0, "classes": _SCENARIO_CLASSES,
                          "prompt_max": 20, "out_max": 4, "seed": 11}},
    "bursty": {"factory": bursty_trace, "n_requests": 12,
               "kwargs": {"burst_size": 6, "burst_gap_s": 5e-5,
                          "classes": _SCENARIO_CLASSES,
                          "prompt_max": 20, "out_max": 4, "seed": 13}},
    # Long batch prompts against short interactive ones — the skew that
    # makes chunked prefill's queue-jump matter.
    "long_prompt": {"factory": poisson_trace, "n_requests": 10,
                    "kwargs": {"rate_rps": 200_000.0, "prompt_mu": 3.6,
                               "prompt_sigma": 0.3,
                               "classes": (
                                   TenantClass("batch", priority=0, share=0.7),
                                   TenantClass("interactive", priority=2,
                                               slo_ttft_s=6e-5, share=0.3,
                                               prompt_scale=0.2),
                               ),
                               "prompt_max": 48, "out_max": 4, "seed": 17}},
}


def scenario_trace(name: str) -> Trace:
    spec = SCENARIOS[name]
    return spec["factory"](spec["n_requests"], **spec["kwargs"])
