"""Traffic from a mix file: the requests each closed-loop client sends.

A mix file (``bench/traffic/<mix>.json``) gives the parameters: its public
`source`, the number of clients (one engine slot each), ``max_len``, the
engine's page size and HBM budget for weights and KV cache (`hbm_budget`),
the prompt and output length distributions
(each lognormal by median and sigma, clipped to [min, max]), the first
token id a prompt may use, and how many requests each client has queued.

Every seed gets the same sizes, dealt to the same clients, so every seed
makes the same work: the seed draws the prompts' token ids (and the
weights), never which sizes come when, since in a closed loop the order of
the sizes sets when each client's next request arrives.  The sizes are the
distribution's quantiles at (j + 1/2) / N over the mix's N requests,
spread over the waves (wave k holds every client's k-th request) so that
each wave spans the whole distribution, and dealt within each wave by one
fixed shuffle.  Each client's first request is admitted during set-up with
an output budget that stands for the rest of a request already in flight:
the budgets of the first requests are the quantiles of the steady state's
residual length, P(r) in proportion to the share of outputs of r tokens or
more.
"""
from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from statistics import NormalDist

import numpy as np

MIXES = Path(__file__).resolve().parent / "traffic"
DEAL = 0               # the one fixed shuffle that deals each wave's sizes to the clients


@dataclasses.dataclass(frozen=True)
class Planned:
    """One request of one client: its prompt's token ids and output budget."""

    client: int
    index: int
    prompt: np.ndarray             # [T] int32
    budget: int


def load_mix(name: str, root: Path = MIXES) -> dict:
    return json.loads((root / f"{name}.json").read_text())


def hbm_budget(mix: dict, card_bytes: int | None) -> float:
    """The bytes of weights and KV cache the engine may keep on the card:
    the mix's ``hbm_budget_bytes``, or its ``hbm_fraction`` of the card's
    memory (`card_bytes`) less the engine's ``working_bytes``."""
    eng = mix["engine"]
    if "hbm_budget_bytes" in eng:
        return float(eng["hbm_budget_bytes"])
    if card_bytes is None:
        raise ValueError("the mix sets its HBM budget as a share of a card, and there is none")
    return eng["hbm_fraction"] * card_bytes - eng["working_bytes"]


def run_rng(seed: int, stream: int) -> np.random.Generator:
    s = int(seed) % (1 << 64)
    return np.random.default_rng([s & 0xFFFFFFFF, s >> 32, stream])


def quantile_lengths(dist: dict, n: int) -> np.ndarray:
    """The n lengths of a lognormal (median, sigma) at the quantiles
    (j + 1/2) / n, rounded and clipped to [min, max]."""
    p = (np.arange(n) + 0.5) / n
    z = np.array([NormalDist().inv_cdf(float(q)) for q in p])
    raw = np.exp(math.log(dist["median"]) + dist["sigma"] * z)
    return np.clip(np.round(raw), dist["min"], dist["max"]).astype(int)


def residual_budgets(outputs: np.ndarray, n: int) -> list[int]:
    """The n quantiles, at (j + 1/2) / n, of the tokens a request in flight
    has left: r with P(r) in proportion to the share of `outputs` of r
    tokens or more (the residual of a renewal process), at least 2 so
    that each decodes."""
    r = np.arange(1, int(outputs.max()) + 1)
    weight = np.array([(outputs >= k).sum() for k in r], dtype=float)
    cdf = np.cumsum(weight) / weight.sum()
    return [max(2, int(r[np.searchsorted(cdf, (j + 0.5) / n)])) for j in range(n)]


def plan(mix: dict, vocab: int, seed: int) -> list[list[Planned]]:
    """Each client's queued requests, in the order it sends them."""
    clients, per = mix["clients"], mix["requests_per_client"]
    n = clients * per
    # the sorted quantiles dealt round the waves: wave k takes k, k + per, ...
    plens = quantile_lengths(mix["prompt"], n).reshape(clients, per).T
    outs = quantile_lengths(mix["output"], n)
    olens = outs.reshape(clients, per).T
    deal = np.random.default_rng(DEAL)                 # the same for every seed
    plens = deal.permuted(plens, axis=1)
    olens = deal.permuted(olens, axis=1)
    olens[0] = deal.permutation(residual_budgets(outs, clients))
    rng = run_rng(seed, 1)
    ids = rng.integers(mix["first_token_id"], vocab, size=int(plens.sum()), dtype=np.int64)
    prompts = np.split(ids.astype(np.int32), np.cumsum(plens.ravel())[:-1])
    return [[Planned(c, k, prompts[k * clients + c], int(olens[k, c])) for k in range(per)]
            for c in range(clients)]


@dataclasses.dataclass
class Track:
    """What the benchmark saw of one request: when it was sent and when
    each token arrived."""

    planned: Planned
    req: object                    # the program's request object
    sent: float = 0.0              # host clock at submission
    stamps: list[float] = dataclasses.field(default_factory=list)
    admitted_at: int = -1          # the step that prefilled it (0: set-up; -1: not yet)


class ClosedLoop:
    """Clients that each send their next request when the last completes.

    `make_request(planned, rid)` builds the program's request and
    `submit(req)` hands it over; after each engine step `observe(now,
    step)` stamps every new token with the host clock and sends the next
    request of each client whose request completed."""

    def __init__(self, plans: list[list[Planned]], make_request, submit):
        self.plans = plans
        self.make_request = make_request
        self.submit = submit
        self.next_index = [0] * len(plans)
        self.live: dict[int, Track] = {}           # client -> current request
        self.done: list[Track] = []
        self._rid = 0

    def send(self, client: int, now: float = 0.0) -> None:
        k = self.next_index[client]
        if k >= len(self.plans[client]):
            raise RuntimeError(f"client {client} has sent all {k} of its requests; "
                               f"raise the mix's requests_per_client")
        self.next_index[client] = k + 1
        req = self.make_request(self.plans[client][k], self._rid)
        self._rid += 1
        self.live[client] = Track(self.plans[client][k], req, now)
        self.submit(req)

    def start(self) -> None:
        for client in range(len(self.plans)):
            self.send(client)

    def observe(self, now: float, step: int) -> tuple[int, list[int], list[int]]:
        """After an engine step: stamp new tokens.  Returns (tokens seen,
        the context lengths the step's decode rows attended, the prompt
        lengths it prefilled), then sends each completed client's next."""
        tokens, ctxs, prefills = 0, [], []
        finished = []
        for client, tr in self.live.items():
            out = tr.req.out_tokens
            new = len(out) - len(tr.stamps)
            if new <= 0:
                continue
            if not tr.stamps:                    # prefilled in this step
                tr.admitted_at = step
                prefills.append(len(tr.planned.prompt))
                decoded = new - 1
            else:
                decoded = new
            if decoded:
                ctxs.append(len(tr.planned.prompt) + len(out) - 1)
            tr.stamps.extend([now] * new)
            tokens += new
            if tr.req.t_done:
                finished.append(client)
        for client in finished:
            self.done.append(self.live.pop(client))
            self.send(client, now)
        return tokens, ctxs, prefills

    def tracks(self) -> list[Track]:
        return self.done + list(self.live.values())
