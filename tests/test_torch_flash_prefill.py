"""The port's flash_prefill (its plain version, on the CPU) against the
JAX package's Pallas kernel in interpret mode and the model-layer attention
oracle, at the shapes of tests/test_flash_prefill.py.  Inputs come from
numpy seeds; fp32 within 2e-4 relative, bf16 within 5e-2."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro_torch.configs as TC
from repro.kernels.flash_prefill import flash_prefill as j_flash_prefill
from repro.models import layers as JL
from repro_torch import bridge
from repro_torch.kernels import flash_prefill
from repro_torch.models import layers as TL
from torch_helpers import FP32_TOL, rel_err

JCFG, TCFG = JC.get_smoke("llama2_7b"), TC.get_smoke("llama2_7b")


def _qkv(b, h, kh, t, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, h, t, hd)).astype(np.float32),
            rng.normal(size=(b, kh, t, hd)).astype(np.float32),
            rng.normal(size=(b, kh, t, hd)).astype(np.float32))


@pytest.mark.parametrize("b,h,kh,t,hd", [(2, 8, 2, 512, 64), (2, 4, 1, 256, 128)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_prefill_matches_reference(b, h, kh, t, hd, causal):
    q, k, v = _qkv(b, h, kh, t, hd, seed=b * t + h)
    got = flash_prefill(*map(torch.from_numpy, (q, k, v)), causal=causal)
    want = j_flash_prefill(*map(jnp.asarray, (q, k, v)), causal=causal, block_q=128,
                           block_k=128, interpret=True)
    assert got.shape == (b, h, t, hd)
    assert rel_err(got, want) < FP32_TOL


def test_flash_prefill_bf16_matches_reference():
    q, k, v = (jnp.asarray(a, jnp.bfloat16) for a in _qkv(1, 4, 2, 256, 64, seed=0))
    want = j_flash_prefill(q, k, v, block_q=128, block_k=128, interpret=True)
    got = flash_prefill(*(bridge.tensor_from_numpy(np.asarray(a), device="cpu")
                          for a in (q, k, v)))
    assert got.dtype == torch.bfloat16
    assert rel_err(got, want) < 5e-2


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t", [100, 33])
def test_flash_prefill_ragged_matches_layer_attention(t, causal):
    """Any T is taken (the reference kernel demands T % block == 0): held
    against the reference's and the port's `_attend_dense` in [B,T,H,hd]."""
    q, k, v = _qkv(2, 4, 2, t, 32, seed=t)
    got = flash_prefill(*map(torch.from_numpy, (q, k, v)), causal=causal)
    tr = lambda a: a.transpose(0, 2, 1, 3)   # noqa: E731
    want = JL._attend_dense(JCFG, *(jnp.asarray(tr(a)) for a in (q, k, v)), causal=causal)
    port = TL._attend_dense(TCFG, *(torch.from_numpy(tr(a).copy()) for a in (q, k, v)),
                            causal=causal)
    assert rel_err(got.transpose(1, 2), want) < FP32_TOL
    assert rel_err(port, want) < FP32_TOL


def test_flash_prefill_validates_shapes():
    q, k, v = map(torch.from_numpy, _qkv(1, 4, 3, 8, 16, seed=1))
    with pytest.raises(ValueError, match="does not fit"):
        flash_prefill(q, k, v)
    q, k, v = map(torch.from_numpy, _qkv(1, 4, 2, 8, 16, seed=1))
    with pytest.raises(ValueError, match="must be"):
        flash_prefill(q[0], k, v)
    with pytest.raises(TypeError, match="dtype"):
        flash_prefill(q, k.double(), v)
