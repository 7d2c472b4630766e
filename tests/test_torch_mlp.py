"""Port K1 (fused LN+MLP) on the CPU, i.e. its plain version, against the
JAX package's Pallas kernel in interpret mode, on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emr2a_tpu.ops.mlp import fused_ln_mlp as jax_fused_ln_mlp
from emr2a_tpu_torch.ops.mlp import fused_ln_mlp, fused_ln_mlp_reference

torch.set_num_threads(1)


def _inputs(rng, T=300, d=64, m=256):
    return dict(
        x=rng.randn(T, d) * 0.5, ln_scale=rng.rand(d) + 0.5,
        ln_bias=rng.randn(d) * 0.1, w1=rng.randn(d, m) * 0.05,
        b1=rng.randn(m) * 0.01, w2=rng.randn(m, d) * 0.05,
        b2=rng.randn(d) * 0.01)


@pytest.mark.parametrize("activation", ["gelu", "quick_gelu"])
def test_fused_ln_mlp_matches_jax_kernel(rng, activation):
    # T = 300 is no multiple of the JAX kernel's token tile
    a = {k: v.astype(np.float32) for k, v in _inputs(rng).items()}
    want = jax_fused_ln_mlp(*(jnp.asarray(v) for v in a.values()),
                            eps=1e-6, activation=activation, tile=128,
                            interpret=True)
    got = fused_ln_mlp(*(torch.from_numpy(v) for v in a.values()),
                       eps=1e-6, activation=activation)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=2e-5, rtol=1e-4)


def test_fused_ln_mlp_bf16_rounding_points_match_jax(rng):
    """In bf16 both sides round h, the activation and fc2's output at the
    same points; what is left is summation order, a bf16 ulp at most."""
    a = {k: v.astype(np.float32) for k, v in _inputs(rng, T=64).items()}
    want = jax_fused_ln_mlp(*(jnp.asarray(v, jnp.bfloat16) for v in a.values()),
                            eps=1e-6, tile=64, interpret=True)
    got = fused_ln_mlp(*(torch.from_numpy(v).to(torch.bfloat16)
                         for v in a.values()), eps=1e-6)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=1e-2, rtol=1e-2)


def test_fused_ln_mlp_rejects_devices_without_a_kernel(rng):
    a = _inputs(rng, T=8)
    args = [torch.from_numpy(v.astype(np.float32)).to("meta")
            for v in a.values()]
    with pytest.raises(ValueError, match="no kernel"):
        fused_ln_mlp(*args)


def test_reference_is_the_cpu_path(rng):
    a = [torch.from_numpy(v.astype(np.float32)) for v in _inputs(rng, T=16).values()]
    torch.testing.assert_close(fused_ln_mlp(*a), fused_ln_mlp_reference(*a),
                               atol=0, rtol=0)
