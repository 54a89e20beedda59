"""The paged attention kernel's two designs, by their host-side models
(no card): which design a launch takes, the remote bytes it loads
(`paged_reads`, what ``paged_splitk_flashattn.host_bytes`` counts on the
card) against a count of every box each reader issues, and the cluster
design's shared memory against its layout worked out by hand."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels import splitk_flashattn as A

BF, F32 = torch.bfloat16, torch.float32


def _issued_bytes(tier, lens, page_size, h, kh, hd, elem, design) -> int:
    """Every remote box every reader loads: each (slot, kv head) has
    ceil(G / heads a CTA) CTAs, which the cluster design groups into
    clusters whose leader loads each in-use page as boxes of 64 columns
    (the in-bounds part of the last), once for K and V when V is the K
    pool; the head-group design's CTAs each load a K and a V box."""
    g = h // kh
    ctas = -(-g // design.heads_per_cta)
    if design.name == "cluster":
        readers, widths = -(-ctas // design.cluster), [min(64, hd - c) for c in range(0, hd, 64)]
    else:
        readers, widths = ctas, [hd]
    loads = 1 if design.alias else 2
    total = 0
    for b in range(tier.shape[0]):
        for c in range(tier.shape[1]):
            if c * page_size < lens[b] and tier[b, c] > 0:
                for _ in range(kh * readers * loads):
                    total += sum(w * page_size * elem for w in widths)
    return total


@pytest.mark.parametrize("b,h,kh,hd,ps,mp,dtype,alias", [
    (4, 128, 1, 576, 16, 10, BF, True),      # MLA: one cluster of 8 a slot, V from K
    (3, 8, 1, 576, 16, 12, BF, False),       # one block, a separate V pool
    (2, 144, 1, 576, 4, 40, BF, True),       # two clusters of 5 a slot
    (3, 2, 2, 1000, 8, 6, BF, False),        # a last box of 40 columns
    (4, 128, 1, 576, 16, 10, F32, True),     # fp32: head-group, one head a CTA
    (4, 32, 8, 128, 16, 10, BF, False),      # GQA at hd 128: head-group, 4 heads a CTA
])
def test_paged_reads_equal_every_box_issued(b, h, kh, hd, ps, mp, dtype, alias):
    rng = np.random.default_rng(hd * mp + h)
    design = A.paged_design(b, h, kh, hd, ps, mp, window=2, dtype=dtype, alias_v=alias)
    assert design.name == ("cluster" if dtype == BF and hd > 256 else "head-group")
    elem = A.elem_bytes(dtype)
    for _ in range(5):
        tier = rng.integers(0, 2, size=(b, mp))
        lens = rng.integers(0, mp * ps + 5, size=b)
        lens[rng.integers(0, b)] = 0
        got = A.paged_reads(tier, lens, ps, h, kh, hd, elem, alias=design.alias,
                            heads_per_cta=design.heads_per_cta, cluster=design.cluster)
        assert got == _issued_bytes(tier, lens, ps, h, kh, hd, elem, design)


def test_mla_reads_each_remote_page_once_against_256_times():
    """At MLA's served shape every in-use remote page crosses the link once
    a slot in the cluster design, and 128 heads x (K + V) = 256 times in
    the head-group design it replaced."""
    ps, h, hd = 16, 128, 576
    tier = np.array([[1, 0, 1, 1], [0, 0, 0, 0], [1, 1, 1, 1]])
    lens = np.array([40, 64, 17])
    page = ps * hd * 2
    new = A.paged_design(3, h, 1, hd, ps, 4, window=1, dtype=BF, alias_v=True)
    old = A.paged_design(3, h, 1, hd, ps, 4, window=1, dtype=BF, alias_v=True,
                         design="head-group")
    reads = {d.name: A.paged_reads(tier, lens, ps, h, 1, hd, 2, alias=d.alias,
                                   heads_per_cta=d.heads_per_cta, cluster=d.cluster)
             for d in (new, old)}
    assert reads == {"cluster": 4 * page, "head-group": 256 * 4 * page}


@pytest.mark.parametrize("b,h,kh,hd,ps,mp,window,alias,stages,cut", [
    (4, 128, 1, 576, 16, 10, 1, True, 2, None),
    (4, 128, 1, 576, 16, 10, 2, False, 3, None),
    (4, 16, 1, 576, 16, 2, 4, True, 2, "chunks"),
    (2, 8, 1, 576, 4, 40, 16, True, 9, "MAX_WINDOW"),
    (2, 2, 2, 1024, 16, 6, 4, False, 2, "SMEM_MAX"),
    (2, 16, 1, 264, 20, 8, 1, False, 2, None),
])
def test_cluster_footprint_is_the_layout_by_hand(b, h, kh, hd, ps, mp, window, alias, stages,
                                                 cut):
    """The cluster design's shared memory: 1024 B of alignment slack, Q (16
    rows of each 64-column box, 128 B a row), the ring (page rows rounded up
    to 16 keys x 128 B a box, K boxes then V boxes unless V is the K pool,
    a full and an empty mbarrier a stage), the partial scores (2 x 4 warps
    x 32 lanes x 8 floats) and (max_pages + b) ints."""
    boxes = -(-hd // 64)
    slot = -(-ps // 16) * 16 * 128
    stage = boxes * slot * (1 if alias else 2)
    want = 1024 + boxes * 16 * 128 + stages * (stage + 16) + 2 * 4 * 32 * 8 * 4 + (mp + b) * 4
    d = A.paged_design(b, h, kh, hd, ps, mp, window=window, dtype=BF, alias_v=alias)
    assert (d.name, d.stages, d.cut, d.smem) == ("cluster", stages, cut, want)
    assert A.paged_smem_footprint_bytes(b, h, kh, hd, ps, mp, window=window, dtype=BF,
                                        alias_v=alias) == want <= A.CLUSTER_SMEM_MAX


@pytest.mark.parametrize("hd,ps,dtype,aligned,design", [
    (576, 16, BF, True, "cluster"),
    (576, 16, F32, True, "head-group"),       # fp32: TF32 products would change parity
    (576, 16, BF, False, "head-group"),       # an unaligned base: no tensor map
    (300, 16, BF, True, "head-group"),        # rows of 600 B: not a 16-byte multiple
    (576, 512, BF, True, "head-group"),       # pages above a box's 256 rows
    (256, 16, BF, True, "head-group"),        # hd <= 256 keeps its design
    (1024, 256, BF, True, "head-group"),      # not one stage of 512 KB fits
])
def test_design_dispatch(hd, ps, dtype, aligned, design):
    got = A.paged_design(4, 32, 1, hd, ps, 8, window=2, dtype=dtype, aligned=aligned)
    assert got.name == design
    assert got.cluster == 1 or got.name == "cluster"
