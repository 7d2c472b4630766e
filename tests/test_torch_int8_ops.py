"""The port's W8A8 ops K5 (``linear_w8a8``), K2 (``fused_ln_mlp_int8``)
and K4 (``fused_ln_attention_int8``) on the CPU, i.e. their plain versions,
against the JAX package's Pallas kernels in interpret mode, on the same
numpy inputs and the same int8 weights.

Tolerances (``_assert_int8_close``):
- f32 activations: every element within 2e-2 (the bound of
  ``tests/test_linear_int8.py``) and at least 99 % within 1e-5. Codes are
  bit-identical where their inputs are; the only source of a larger error
  is a rare one-code flip where an f32 LN or activation value computed in
  another summation order lands on the other side of a rounding boundary.
- bf16 activations: at least 99 % of elements within one bf16 ulp of the
  JAX value, every element within 2e-2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emr2a_tpu.ops.attention_block import (
    fused_ln_attention_int8 as jax_fused_ln_attention_int8,
)
from emr2a_tpu.ops.linear_int8 import linear_w8a8 as jax_linear_w8a8
from emr2a_tpu.ops.mlp import fused_ln_mlp_int8 as jax_fused_ln_mlp_int8
from emr2a_tpu_torch.ops import attention_block, linear_int8, mlp
from emr2a_tpu_torch.ops.mlp import quantize_weight_int8

torch.set_num_threads(1)


def _bf16_ulp(v: np.ndarray) -> np.ndarray:
    mag = np.maximum(np.abs(v), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(mag)) - 7).astype(np.float32)


def _assert_int8_close(got: torch.Tensor, want, bf16: bool) -> None:
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    err = np.abs(got - want)
    assert err.max() <= 2e-2, err.max()
    within = err <= (_bf16_ulp(want) if bf16 else 1e-5)
    assert within.mean() >= 0.99, within.mean()


def _w8(rng, K, N, std=0.05):
    q, s = quantize_weight_int8((rng.randn(K, N) * std).astype(np.float32))
    return q, s.reshape(-1)


# -- K5 -----------------------------------------------------------------------

@pytest.mark.parametrize("T", [37, 1100])   # JAX: in-kernel quantize; s8 stream
@pytest.mark.parametrize("use_bias", [True, False])
def test_linear_w8a8_f32_matches_jax(rng, T, use_bias):
    K, N = 64, 256
    x = rng.randn(T, K).astype(np.float32)
    wq, ws = _w8(rng, K, N)
    b = (rng.randn(N) * 0.1).astype(np.float32) if use_bias else None
    want = jax_linear_w8a8(jnp.asarray(x), jnp.asarray(wq), jnp.asarray(ws),
                           None if b is None else jnp.asarray(b),
                           out_dtype=jnp.float32, interpret=True)
    got = linear_int8.linear_w8a8(
        torch.from_numpy(x), torch.from_numpy(wq), torch.from_numpy(ws),
        None if b is None else torch.from_numpy(b), out_dtype=torch.float32)
    assert got.dtype == torch.float32
    _assert_int8_close(got, want, bf16=False)


@pytest.mark.parametrize("lead", [(3, 37), (1100,)])
def test_linear_w8a8_bf16_matches_jax(rng, lead):
    """bf16 in and out (the text tower's working dtype), leading axes kept."""
    K, N = 96, 128
    x = rng.randn(*lead, K).astype(np.float32)
    wq, ws = _w8(rng, K, N)
    b = (rng.randn(N) * 0.1).astype(np.float32)
    want = jax_linear_w8a8(jnp.asarray(x, jnp.bfloat16), jnp.asarray(wq),
                           jnp.asarray(ws), jnp.asarray(b, jnp.bfloat16),
                           interpret=True)
    got = linear_int8.linear_w8a8(
        torch.from_numpy(x).bfloat16(), torch.from_numpy(wq),
        torch.from_numpy(ws), torch.from_numpy(b).bfloat16())
    assert got.dtype == torch.bfloat16 and got.shape == (*lead, N)
    _assert_int8_close(got, want, bf16=True)


def test_linear_w8a8_zero_rows_give_the_bias(rng):
    x = torch.zeros(4, 64)
    wq, ws = _w8(rng, 64, 128)
    b = torch.from_numpy(rng.randn(128).astype(np.float32))
    got = linear_int8.linear_w8a8(x, torch.from_numpy(wq), torch.from_numpy(ws),
                                  b, out_dtype=torch.float32)
    torch.testing.assert_close(got, b.expand(4, 128), atol=0, rtol=0)


def test_int8_wrappers_reject_devices_without_a_kernel(rng):
    wq, ws = _w8(rng, 64, 128)
    x = torch.zeros(4, 64, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        linear_int8.linear_w8a8(x, torch.from_numpy(wq), torch.from_numpy(ws))
    with pytest.raises(ValueError, match="no kernel"):
        linear_int8.quantize_rows(x)


# -- K2 -----------------------------------------------------------------------

def _mlp_args(rng, T, d, m):
    mk = lambda *s: (rng.randn(*s) * 0.05).astype(np.float32)
    w1q, w1s = _w8(rng, d, m)
    w2q, w2s = _w8(rng, m, d)
    return [(rng.randn(T, d) * 0.5).astype(np.float32),
            (rng.rand(d) + 0.5).astype(np.float32), mk(d),
            w1q, w1s, mk(m), w2q, w2s, mk(d)]


_MLP_FLOAT = (0, 1, 2, 5, 8)      # x, LN, biases: in the working dtype


@pytest.mark.parametrize("T", [300, 7])
def test_fused_ln_mlp_int8_f32_matches_jax(rng, T):
    a = _mlp_args(rng, T, 64, 256)
    want = jax_fused_ln_mlp_int8(*(jnp.asarray(v) for v in a), eps=1e-6,
                                 tile=128, interpret=True)
    got = mlp.fused_ln_mlp_int8(*(torch.from_numpy(v) for v in a), eps=1e-6)
    _assert_int8_close(got, want, bf16=False)


def test_fused_ln_mlp_int8_bf16_matches_jax(rng):
    a = _mlp_args(rng, 200, 64, 256)
    want = jax_fused_ln_mlp_int8(
        *(jnp.asarray(v, jnp.bfloat16) if i in _MLP_FLOAT else jnp.asarray(v)
          for i, v in enumerate(a)), eps=1e-6, tile=128, interpret=True)
    got = mlp.fused_ln_mlp_int8(
        *(torch.from_numpy(v).bfloat16() if i in _MLP_FLOAT
          else torch.from_numpy(v) for i, v in enumerate(a)), eps=1e-6)
    assert got.dtype == torch.bfloat16
    _assert_int8_close(got, want, bf16=True)


# -- K4 -----------------------------------------------------------------------

def _attn_args(rng, B, S, d):
    mk = lambda *s: (rng.randn(*s) * 0.05).astype(np.float32)
    args = [(rng.randn(B, S, d) * 0.5).astype(np.float32),
            (rng.rand(d) + 0.5).astype(np.float32), mk(d)]
    for _ in range(4):
        args += [*_w8(rng, d, d), mk(d)]
    return args


def _attn_float(i):
    return i < 3 or (i - 3) % 3 == 2


@pytest.mark.parametrize("B,S,d,H,valid_len", [
    (3, 50, 64, 4, 45),
    (2, 17, 32, 2, 13),
    (2, 33, 64, 2, None),
])
def test_fused_ln_attention_int8_f32_matches_jax(rng, B, S, d, H, valid_len):
    a = _attn_args(rng, B, S, d)
    want = jax_fused_ln_attention_int8(
        *(jnp.asarray(v) for v in a), num_heads=H, head_group=2,
        valid_len=valid_len, interpret=True)
    got = attention_block.fused_ln_attention_int8(
        *(torch.from_numpy(v) for v in a), num_heads=H, valid_len=valid_len)
    n = S if valid_len is None else valid_len
    _assert_int8_close(got[:, :n], np.asarray(want)[:, :n], bf16=False)


def test_fused_ln_attention_int8_bf16_matches_jax(rng):
    B, S, d, H, vl = 2, 40, 64, 4, 37
    a = _attn_args(rng, B, S, d)
    want = jax_fused_ln_attention_int8(
        *(jnp.asarray(v, jnp.bfloat16) if _attn_float(i) else jnp.asarray(v)
          for i, v in enumerate(a)), num_heads=H, head_group=2,
        valid_len=vl, interpret=True)
    got = attention_block.fused_ln_attention_int8(
        *(torch.from_numpy(v).bfloat16() if _attn_float(i)
          else torch.from_numpy(v) for i, v in enumerate(a)),
        num_heads=H, valid_len=vl)
    assert got.dtype == torch.bfloat16
    _assert_int8_close(got[:, :vl], np.asarray(want, np.float32)[:, :vl],
                       bf16=True)


def test_fused_int8_blocks_keep_padding_rows_finite(rng):
    """Rows past valid_len (zero padding in the ViT) are junk but finite."""
    a = [torch.from_numpy(v) for v in _attn_args(rng, 2, 16, 64)]
    a[0][:, 13:] = 0.0
    out = attention_block.fused_ln_attention_int8(*a, num_heads=4, valid_len=13)
    assert torch.isfinite(out).all()
    m = [torch.from_numpy(v) for v in _mlp_args(rng, 8, 64, 128)]
    m[0][5:] = 0.0
    assert torch.isfinite(mlp.fused_ln_mlp_int8(*m)).all()
