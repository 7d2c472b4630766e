"""Port K3 (fused LN+attention) on the CPU, i.e. its plain version,
against the JAX package's Pallas kernel in interpret mode, on the same
numpy inputs. Only the valid rows are compared: later rows are padding."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emr2a_tpu.ops.attention_block import (
    fused_ln_attention as jax_fused_ln_attention,
)
from emr2a_tpu_torch.ops.attention_block import _check_kernel_shape, fused_ln_attention

torch.set_num_threads(1)


def _inputs(rng, B, S, d):
    mk = lambda *sh: rng.randn(*sh) * 0.05
    return dict(x=rng.randn(B, S, d) * 0.5, ln_scale=rng.rand(d) + 0.5,
                ln_bias=mk(d), wq=mk(d, d), bq=mk(d), wk=mk(d, d), bk=mk(d),
                wv=mk(d, d), bv=mk(d), wo=mk(d, d), bo=mk(d))


@pytest.mark.parametrize("B,S,d,H,valid_len", [
    (3, 50, 64, 4, 45),
    (2, 197, 48, 4, 190),
    (4, 17, 32, 2, 13),
    (2, 33, 64, 2, None),
    (1, 577, 64, 2, 570),
])
def test_fused_ln_attention_matches_jax_kernel(rng, B, S, d, H, valid_len):
    a = {k: v.astype(np.float32) for k, v in _inputs(rng, B, S, d).items()}
    want = jax_fused_ln_attention(*(jnp.asarray(v) for v in a.values()),
                                  num_heads=H, head_group=2, block_b=1,
                                  valid_len=valid_len, interpret=True)
    got = fused_ln_attention(*(torch.from_numpy(v) for v in a.values()),
                             num_heads=H, valid_len=valid_len)
    n = S if valid_len is None else valid_len
    np.testing.assert_allclose(got.numpy()[:, :n], np.asarray(want)[:, :n],
                               atol=2e-5, rtol=1e-4)


def test_fused_ln_attention_bf16_rounding_points_match_jax(rng):
    """bf16 on both sides: h, q/k/v, the probabilities and the attention
    output are rounded at the same points."""
    B, S, d, H, vl = 2, 40, 64, 4, 37
    a = {k: v.astype(np.float32) for k, v in _inputs(rng, B, S, d).items()}
    want = jax_fused_ln_attention(
        *(jnp.asarray(v, jnp.bfloat16) for v in a.values()), num_heads=H,
        head_group=2, valid_len=vl, interpret=True)
    got = fused_ln_attention(*(torch.from_numpy(v).to(torch.bfloat16)
                               for v in a.values()), num_heads=H, valid_len=vl)
    np.testing.assert_allclose(got.float().numpy()[:, :vl],
                               np.asarray(want, np.float32)[:, :vl],
                               atol=1e-2, rtol=1e-2)


def test_fused_ln_attention_rejects_devices_without_a_kernel(rng):
    a = [torch.from_numpy(v.astype(np.float32)).to("meta")
         for v in _inputs(rng, 1, 8, 64).values()]
    with pytest.raises(ValueError, match="no kernel"):
        fused_ln_attention(*a, num_heads=1)


@pytest.mark.parametrize("S,d,H", [(577, 768, 12), (1025, 384, 6), (1, 128, 2)])
def test_kernel_shape_rule_takes_any_sequence_length(S, d, H):
    """The CUDA kernels' shape rule: head dim 64 and d % 128 == 0, any S
    (ViT-B at S = 577, which the routing rule admits)."""
    _check_kernel_shape(S, d, H)


def test_kernel_shape_rule_refuses_other_head_dims():
    with pytest.raises(ValueError, match="head dim 64"):
        _check_kernel_shape(577, 384, 12)
