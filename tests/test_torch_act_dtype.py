"""``act_dtype`` and ``tile`` of the port's K1 (``fused_ln_mlp``) and K2
(``fused_ln_mlp_int8``) on the CPU, i.e. their plain versions, against the
JAX package's Pallas kernels in interpret mode on the same numpy inputs.

With ``act_dtype=bfloat16`` JAX's CPU interpret mode evaluates the gelu as
XLA evaluates ``jax.nn.gelu`` on a bf16 array: bf16 constants, each op in
f32 rounded to bf16, the last product left unrounded where a convert to
f32 follows. ``gelu_tanh_bf16`` reproduces that bit for bit (held here on
400,000 values). Through the block the two then differ only by the
products' summation order: bf16 inputs agree exactly on these inputs; f32
inputs within atol 2e-3 (a bf16-rounded fc1 value may land on the other
side of a boundary, one bf16 ulp of h1) for K1, and within the W8A8 tests'
bound for K2 (2e-2, 99 % within 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emr2a_tpu.ops.mlp import fused_ln_mlp as jax_fused_ln_mlp
from emr2a_tpu.ops.mlp import fused_ln_mlp_int8 as jax_fused_ln_mlp_int8
from emr2a_tpu_torch.ops import mlp
from emr2a_tpu_torch.ops.mlp import quantize_weight_int8

torch.set_num_threads(1)


def test_gelu_tanh_bf16_equals_xla_bit_for_bit():
    x = (np.random.RandomState(3).randn(400_000) * 3).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    gelu = lambda v: jax.nn.gelu(v, approximate=True)
    want_bf16 = np.asarray(jax.jit(gelu)(xb).astype(jnp.float32))
    want_f32 = np.asarray(jax.jit(lambda v: gelu(v).astype(jnp.float32))(xb))
    got = mlp.gelu_tanh_bf16(torch.from_numpy(x))
    np.testing.assert_array_equal(got.to(torch.bfloat16).float().numpy(), want_bf16)
    np.testing.assert_array_equal(got.numpy(), want_f32)


def _mlp_inputs(rng, T=300, d=64, m=256):
    # fc1 values of a few units, so that the gelu's bf16 rounding matters
    return [rng.randn(T, d) * 0.5, rng.rand(d) + 0.5, rng.randn(d) * 0.1,
            rng.randn(d, m) * 0.3, rng.randn(m) * 0.1, rng.randn(m, d) * 0.05,
            rng.randn(d) * 0.01]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_ln_mlp_act_bf16_matches_jax(rng, dtype):
    a = [v.astype(np.float32) for v in _mlp_inputs(rng)]
    want = jax_fused_ln_mlp(*(jnp.asarray(v, dtype) for v in a), tile=128,
                            act_dtype=jnp.bfloat16, interpret=True)
    got = mlp.fused_ln_mlp(*(torch.from_numpy(v).to(getattr(torch, dtype))
                             for v in a), tile=128, act_dtype=torch.bfloat16)
    want = np.asarray(want, np.float32)
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got.float().numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, atol=2e-3, rtol=0)


def _int8_inputs(rng, T=300, d=64, m=256):
    x, s, b, w1, b1, w2, b2 = (v.astype(np.float32) for v in _mlp_inputs(rng, T, d, m))
    (q1, s1), (q2, s2) = quantize_weight_int8(w1), quantize_weight_int8(w2)
    return [x, s, b, q1, s1.reshape(-1), b1, q2, s2.reshape(-1), b2]


_FLOAT = (0, 1, 2, 5, 8)     # x, LN and biases take the working dtype


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_ln_mlp_int8_act_bf16_matches_jax(rng, dtype):
    a = _int8_inputs(rng)
    want = jax_fused_ln_mlp_int8(
        *(jnp.asarray(v, dtype) if i in _FLOAT else jnp.asarray(v)
          for i, v in enumerate(a)), tile=128, act_dtype=jnp.bfloat16,
        interpret=True)
    got = mlp.fused_ln_mlp_int8(
        *(torch.from_numpy(v).to(getattr(torch, dtype)) if i in _FLOAT
          else torch.from_numpy(v) for i, v in enumerate(a)),
        tile=128, act_dtype=torch.bfloat16)
    want = np.asarray(want, np.float32)
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got.float().numpy(), want)
    else:
        err = np.abs(got.numpy() - want)
        assert err.max() <= 2e-2 and (err <= 1e-5).mean() >= 0.99


def test_act_bf16_changes_the_result_and_f32_is_the_default(rng):
    a = [torch.from_numpy(v.astype(np.float32)) for v in _mlp_inputs(rng, T=64)]
    plain = mlp.fused_ln_mlp(*a)
    assert torch.equal(mlp.fused_ln_mlp(*a, act_dtype=torch.float32, tile=64), plain)
    assert not torch.equal(mlp.fused_ln_mlp(*a, act_dtype=torch.bfloat16), plain)
    b = [torch.from_numpy(v) for v in _int8_inputs(rng, T=64)]
    plain8 = mlp.fused_ln_mlp_int8(*b)
    assert torch.equal(mlp.fused_ln_mlp_int8(*b, act_dtype=torch.float32, tile=32), plain8)
    assert not torch.equal(mlp.fused_ln_mlp_int8(*b, act_dtype=torch.bfloat16), plain8)


def test_act_dtype_other_than_f32_and_bf16_raises(rng):
    a = [torch.from_numpy(v.astype(np.float32)) for v in _mlp_inputs(rng, T=8)]
    with pytest.raises(ValueError, match="act_dtype"):
        mlp.fused_ln_mlp(*a, act_dtype=torch.float16)
    b = [torch.from_numpy(v) for v in _int8_inputs(rng, T=8)]
    with pytest.raises(ValueError, match="act_dtype"):
        mlp.fused_ln_mlp_int8(*b, act_dtype=torch.float64)
