"""Mamba-2 (SSD, state-space duality) blocks in PyTorch — arXiv:2405.21060.

Counterpart of ``src/repro/models/ssm.py``.  Prefill uses the chunked dual
form (matmuls within a chunk, a recurrence over chunk states); decode uses
the O(1)-state recurrent form.  Grouped B/C (``ssm_n_groups``) broadcast
over heads like GQA, each group repeated over consecutive heads
(``torch.repeat_interleave``, the reference's ``jnp.repeat``).  The
reference computes all of this in XLA, outside Pallas, so plain PyTorch is
its counterpart; where it scans over chunks the port loops.

Every function that consumes a tierable projection takes ``mm``, so the
serving layer runs ``z/x/bc/dt_proj`` and ``ssm_out`` through the
direct-access GEMM.  Unlike the reference, `ssm_block_prefill` returns the
conv cache (the last W-1 pre-conv inputs ``[x | B | C]``) from the block's
own projections instead of projecting ``x_proj`` and ``bc_proj`` a second
time, so prefill reads their remote halves once; the cache is the same.
`ssm_block_chunk` continues both carries over a prompt chunk (chunked
prefill).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.tiering import matmul
from repro_torch.models.layers import rmsnorm

CHUNK = 256


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """Causal segment-sums: out[..., t, s] = sum_{s < u <= t} a[..., u]
    (-inf above the diagonal).  Used for the decay matrix
    L = exp(segsum(dt·A)) of the SSD dual form."""
    t = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=a.device))
    return out.masked_fill(~mask, -torch.inf)


def ssd_chunked(
    x: torch.Tensor,        # [B,T,H,P]   (P = head dim)
    dt: torch.Tensor,       # [B,T,H]     (post-softplus)
    a: torch.Tensor,        # [H]         (negative; A = -exp(A_log))
    b_mat: torch.Tensor,    # [B,T,G,S]
    c_mat: torch.Tensor,    # [B,T,G,S]
    chunk: int = CHUNK,
    h0: torch.Tensor | None = None,   # [B,H,P,S] initial state
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD.  Returns (y [B,T,H,P], final_state [B,H,P,S]).

    A T that is no multiple of `chunk` is padded with zero steps; `dt` is
    already past its softplus, so a padded step decays by exp(0) = 1 and
    adds nothing, and the final state is that of the T real steps."""
    bsz, t, h, p = x.shape
    g, s = b_mat.shape[2], b_mat.shape[3]
    rep = h // g
    if t % chunk:
        pad = chunk - t % chunk
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b_mat = F.pad(b_mat, (0, 0, 0, 0, 0, pad))
        c_mat = F.pad(c_mat, (0, 0, 0, 0, 0, pad))
    tt = x.shape[1]
    nc = tt // chunk

    xc = x.reshape(bsz, nc, chunk, h, p)
    dtc = dt.reshape(bsz, nc, chunk, h).float()
    bc = torch.repeat_interleave(b_mat.reshape(bsz, nc, chunk, g, s), rep, dim=3)  # [B,N,Q,H,S]
    cc = torch.repeat_interleave(c_mat.reshape(bsz, nc, chunk, g, s), rep, dim=3)

    da = dtc * a[None, None, None, :]                              # [B,N,Q,H]
    da_cum = torch.cumsum(da, dim=2)                               # within-chunk
    da_total = da_cum[:, :, -1]                                    # [B,N,H]

    # 1) intra-chunk (dual/attention form): L[t,s] = exp(segsum(da))
    l_mat = torch.exp(_segsum(da.movedim(-1, 2)))                  # [B,N,H,Q,Q]
    scores = torch.einsum("bnqhs,bnkhs->bnhqk", cc, bc)            # [B,N,H,Q,Q]
    y_diag = torch.einsum("bnhqk,bnhqk,bnkh,bnkhp->bnqhp",
                          scores, l_mat.to(scores.dtype), dtc.to(scores.dtype), xc)

    # 2) chunk states: decay from s to the end of the chunk
    decay_states = torch.exp(da_total[:, :, None, :] - da_cum)     # [B,N,Q,H]
    states = torch.einsum("bnqhs,bnqh,bnqhp->bnhps",
                          bc, (dtc * decay_states).to(bc.dtype), xc)

    # 3) inter-chunk recurrence over chunk states (the state entering each chunk)
    carry = h0 if h0 is not None else torch.zeros((bsz, h, p, s), dtype=states.dtype,
                                                  device=x.device)
    prev = []
    for n in range(nc):
        prev.append(carry)
        carry = carry * torch.exp(da_total[:, n])[:, :, None, None].to(carry.dtype) + states[:, n]
    prev_states = torch.stack(prev, dim=1)                         # [B,N,H,P,S]

    # 4) inter-chunk contribution
    state_decay = torch.exp(da_cum)                                # [B,N,Q,H]
    y_off = torch.einsum("bnqhs,bnhps,bnqh->bnqhp",
                         cc, prev_states, state_decay.to(cc.dtype))
    y = (y_diag + y_off).reshape(bsz, tt, h, p)[:, :t]
    return y, carry


def ssd_decode_step(
    x: torch.Tensor,        # [B,H,P]
    dt: torch.Tensor,       # [B,H]
    a: torch.Tensor,        # [H]
    b_vec: torch.Tensor,    # [B,G,S]
    c_vec: torch.Tensor,    # [B,G,S]
    state: torch.Tensor,    # [B,H,P,S]
) -> tuple[torch.Tensor, torch.Tensor]:
    """One recurrent step: h <- h·exp(dt·A) + dt·(B ⊗ x);  y = h·C."""
    h, g = x.shape[1], b_vec.shape[1]
    rep = h // g
    b_h = torch.repeat_interleave(b_vec, rep, dim=1)               # [B,H,S]
    c_h = torch.repeat_interleave(c_vec, rep, dim=1)
    decay = torch.exp(dt.float() * a[None, :])[..., None, None]
    upd = torch.einsum("bh,bhs,bhp->bhps", dt.to(x.dtype), b_h, x)
    state = state * decay.to(state.dtype) + upd
    y = torch.einsum("bhps,bhs->bhp", state, c_h)
    return y, state


# --------------------------------------------------------------------------
# Full Mamba-2 block (in_proj -> conv -> SSD -> gated norm -> out_proj)
# --------------------------------------------------------------------------
def _project_in(cfg: ModelConfig, x: torch.Tensor, p: dict, mm=matmul):
    """The separate z/x/BC/dt projections; `mm` is the tier-aware matmul."""
    return mm(x, p["z_proj"]), mm(x, p["x_proj"]), mm(x, p["bc_proj"]), mm(x, p["dt_proj"])


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d. xbc: [B,T,C], w: [W,C]."""
    width = w.shape[0]
    pad = F.pad(xbc, (0, 0, width - 1, 0))
    out = sum(pad[:, i: i + xbc.shape[1]] * w[i] for i in range(width))
    return F.silu(out)


def _conv_split(cfg: ModelConfig, xs: torch.Tensor, bc: torch.Tensor, p: dict):
    """The conv applied to x and to B/C separately (as the reference)."""
    d_inner = cfg.ssm_expand * cfg.d_model
    return _causal_conv(xs, p["conv_w"][:, :d_inner]), _causal_conv(bc, p["conv_w"][:, d_inner:])


def _gated_out(cfg: ModelConfig, y: torch.Tensor, x_ssm: torch.Tensor, z: torch.Tensor,
               p: dict, mm) -> torch.Tensor:
    """The skip through D, the gated RMSNorm and the out projection."""
    y = y + x_ssm * p["D"][..., None]
    y = y.reshape(*z.shape)
    y = rmsnorm(y * F.silu(z), p["ssm_norm_w"], cfg.norm_eps)
    return mm(y, p["ssm_out"])


def _ssm_forward(cfg: ModelConfig, x: torch.Tensor, p: dict, h0, mm):
    """`ssm_block`'s body; also returns the pre-conv inputs [B,T,C]."""
    bsz, t, _ = x.shape
    nh = cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim
    g, s = cfg.ssm_n_groups, cfg.ssm_state
    z, xs, bc, dt = _project_in(cfg, x, p, mm)
    x_conv, bc_conv = _conv_split(cfg, xs, bc, p)
    b_mat, c_mat = torch.chunk(bc_conv, 2, dim=-1)
    x_ssm = x_conv.reshape(bsz, t, nh, cfg.ssm_head_dim)
    dt = F.softplus(dt.float() + p["dt_bias"])
    a = -torch.exp(p["A_log"].float())
    y, final = ssd_chunked(x_ssm, dt, a, b_mat.reshape(bsz, t, g, s),
                           c_mat.reshape(bsz, t, g, s), h0=h0, chunk=cfg.ssm_chunk)
    return _gated_out(cfg, y, x_ssm, z, p, mm), final, torch.cat([xs, bc], dim=-1)


def ssm_block(cfg: ModelConfig, x: torch.Tensor, p: dict, h0=None, mm=matmul):
    """Full-sequence Mamba-2 block. x: [B,T,d] -> (y [B,T,d], final_state)."""
    y, final, _ = _ssm_forward(cfg, x, p, h0, mm)
    return y, final


def ssm_block_prefill(cfg: ModelConfig, x: torch.Tensor, p: dict, mm=matmul):
    """`ssm_block` from a zero state that also returns the decode caches:
    (y [B,T,d], conv_cache [B,W-1,C], state [B,H,P,S]).  The conv cache is
    the last W-1 pre-conv inputs, zero-padded on the left for a prompt
    shorter than that (the conv's own zero history)."""
    y, final, xbc = _ssm_forward(cfg, x, p, None, mm)
    width = cfg.ssm_conv_width
    conv = F.pad(xbc, (0, 0, width - 1, 0))[:, -(width - 1):]
    return y, conv, final


def ssm_block_chunk(cfg: ModelConfig, x: torch.Tensor, p: dict, conv_cache: torch.Tensor,
                    state: torch.Tensor, mm=matmul):
    """Multi-token Mamba-2 continuation (chunked prefill).

    x: [B,n,d], a chunk of hidden states; conv_cache: [B,W-1,C], the last
    pre-conv inputs of everything before the chunk (zeros at the sequence
    start, where this is `_causal_conv`'s zero padding); state: [B,H,P,S],
    the SSD state entering the chunk.  Returns (y [B,n,d], conv_cache,
    state), both carries advanced past the chunk, so a prompt fed in
    chunks of any size leaves the carries of one whole-sequence pass."""
    bsz, t, _ = x.shape
    d_inner = cfg.ssm_expand * cfg.d_model
    nh = d_inner // cfg.ssm_head_dim
    g, s = cfg.ssm_n_groups, cfg.ssm_state
    width = cfg.ssm_conv_width
    z, xs, bc, dt = _project_in(cfg, x, p, mm)
    window = torch.cat([conv_cache, torch.cat([xs, bc], dim=-1).to(conv_cache.dtype)],
                       dim=1)                                      # [B,W-1+n,C]
    # depthwise conv with history: out[j] = sum_i w[i]·window[j+i] (w[W-1]
    # multiplies the current token, the decode step's stencil)
    xbc = F.silu(sum(window[:, i: i + t] * p["conv_w"][i] for i in range(width)))
    x_ssm, b_mat, c_mat = torch.split(xbc, [d_inner, g * s, g * s], dim=-1)
    x_ssm = x_ssm.reshape(bsz, t, nh, cfg.ssm_head_dim)
    dt = F.softplus(dt.float() + p["dt_bias"])
    a = -torch.exp(p["A_log"].float())
    y, state = ssd_chunked(x_ssm, dt, a, b_mat.reshape(bsz, t, g, s),
                           c_mat.reshape(bsz, t, g, s), h0=state, chunk=cfg.ssm_chunk)
    return _gated_out(cfg, y, x_ssm, z, p, mm), window[:, -(width - 1):], state


def ssm_block_decode(cfg: ModelConfig, x: torch.Tensor, p: dict, conv_cache: torch.Tensor,
                     state: torch.Tensor, mm=matmul):
    """Single-token Mamba-2 step.

    x: [B,1,d]; conv_cache: [B,W-1,conv_dim] (trailing inputs);
    state: [B,H,P,S].  Returns (y [B,1,d], conv_cache, state)."""
    bsz = x.shape[0]
    d_inner = cfg.ssm_expand * cfg.d_model
    nh = d_inner // cfg.ssm_head_dim
    g, s = cfg.ssm_n_groups, cfg.ssm_state
    z, xs, bc, dt = (v[:, 0] for v in _project_in(cfg, x[:, :1], p, mm))
    xbc_new = torch.cat([xs, bc], dim=-1)
    window = torch.cat([conv_cache, xbc_new[:, None].to(conv_cache.dtype)], dim=1)  # [B,W,C]
    conv_cache = window[:, 1:]
    xbc = F.silu(torch.einsum("bwc,wc->bc", window, p["conv_w"]))
    x_ssm, b_vec, c_vec = torch.split(xbc, [d_inner, g * s, g * s], dim=-1)
    x_ssm = x_ssm.reshape(bsz, nh, cfg.ssm_head_dim)
    dt = F.softplus(dt.float() + p["dt_bias"])
    a = -torch.exp(p["A_log"].float())
    y, state = ssd_decode_step(x_ssm, dt, a, b_vec.reshape(bsz, g, s),
                               c_vec.reshape(bsz, g, s), state)
    return _gated_out(cfg, y, x_ssm, z, p, mm)[:, None], conv_cache, state
