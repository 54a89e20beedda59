"""Whether the timed path served the right tokens.

After the window, a sample of the requests it served, drawn from the seed,
is run through the plain reference once each (prompt and served tokens as
one sequence).  At every served token the reference's best logit lies some
way above the logit of the token served: 0 where they agree.  The widest
such gap over the sample is the number compared, `logit_gap`, against the
cell's limit in ``bench/limits/<cell>.json``.

The sample always holds the request with the most served tokens and,
where the window admitted any, one that the window prefilled, so the
comparison covers prefill as well as decode; the rest are drawn from the
seed until it holds `SAMPLE_TOKENS` served tokens or `SAMPLE_MAX` requests.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from bench.clients import Track, run_rng
from bench.reference import decoder

LIMITS = Path(__file__).resolve().parent / "limits"
SAMPLE_TOKENS = 256
SAMPLE_MAX = 6


def load_limits(cell: str, root: Path = LIMITS) -> dict:
    return json.loads((root / f"{cell}.json").read_text())


def sample(tracks: list[Track], seed: int) -> list[Track]:
    """The requests judged: served ones only (at least one token)."""
    served = [t for t in tracks if t.req.out_tokens]
    if not served:
        return []
    longest = max(served, key=lambda t: len(t.req.out_tokens))
    picked = [longest]
    admitted = [t for t in served if t.admitted_at > 0 and t is not longest]
    rng = run_rng(seed, 2)
    if admitted:
        picked.append(admitted[int(rng.integers(len(admitted)))])
    rest = [t for t in served if all(t is not p for p in picked)]
    for i in rng.permutation(len(rest)):
        if sum(len(t.req.out_tokens) for t in picked) >= SAMPLE_TOKENS or len(picked) >= SAMPLE_MAX:
            break
        picked.append(rest[int(i)])
    return picked


def gaps(model: dict, seed: int, picked: list[Track], device,
         precisions: tuple[str, ...] = ("fp32",)) -> dict[str, np.ndarray]:
    """Per served token of the sample, the reference's gap: for "fp32" the
    gap of the token the program served; for a lower precision the gap of
    the token that precision ranks first at the same position."""
    seqs, score, served = [], [], []
    for t in picked:
        out = torch.as_tensor(t.req.out_tokens, dtype=torch.long)
        prompt = torch.as_tensor(t.planned.prompt, dtype=torch.long)
        seqs.append(torch.cat([prompt, out[:-1]]))
        score.append(torch.arange(len(prompt) - 1, len(prompt) - 1 + len(out)))
        served.append(out)
    logits = decoder.logits_at(model, seed, seqs, score, device, precisions,
                               getattr(torch, model.get("dtype", "bfloat16")))
    ref = torch.cat(logits["fp32"])
    best = ref.max(dim=-1).values
    out: dict[str, np.ndarray] = {}
    for p in precisions:
        tok = (torch.cat(served).to(ref.device) if p == "fp32"
               else torch.cat(logits[p]).argmax(dim=-1))
        out[p] = (best - ref.gather(1, tok[:, None])[:, 0]).cpu().numpy()
    return out
