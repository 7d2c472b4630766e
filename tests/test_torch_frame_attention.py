"""The port's per-frame attention (K8) and fused short-sequence attention
(K9) on the CPU, i.e. their plain versions, against the JAX package:

- ``fused_attention_reference`` against JAX's K9 in interpret mode, at
  ``tests/test_attention.py``'s cases and tolerance (atol 2e-5, rtol 1e-4),
  padded keys included: big keys must not draw mass from the padding;
- ``frame_flash_attention_reference`` against the JAX vision tower's einsum
  path (the library TPU flash kernel has no interpret mode; this einsum is
  the JAX package's own oracle for it, ``tests/test_vision_flash.py``) at
  2e-5, and the port's tower with ``attn_impl`` flash against its einsum
  path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emr2a_tpu.models.qwen3_vl import QwenVisionConfig as JaxVisionConfig
from emr2a_tpu.models.qwen3_vl import QwenVisionTower as JaxVisionTower
from emr2a_tpu.ops.attention import fused_attention as jax_fused_attention
from emr2a_tpu_torch.models import qwen3_vl
from emr2a_tpu_torch.models.convert import params_from_jax
from emr2a_tpu_torch.ops import attention, vision_flash

torch.set_num_threads(1)


@pytest.mark.parametrize("B,S,H,D,key_shift", [
    (2, 197, 4, 64, 0.0), (1, 128, 2, 32, 0.0), (3, 50, 1, 16, 0.0),
    (1, 100, 2, 32, 5.0),          # big keys: padding must not leak
])
def test_fused_attention_matches_jax(rng, B, S, H, D, key_shift):
    q = rng.randn(B, S, H, D).astype(np.float32)
    k = rng.randn(B, S, H, D).astype(np.float32) + key_shift
    v = rng.randn(B, S, H, D).astype(np.float32)
    want = np.asarray(jax_fused_attention(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), interpret=True))
    got = attention.fused_attention(*(torch.from_numpy(t) for t in (q, k, v)))
    assert got.shape == (B, S, H, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-4)
    assert attention.LAUNCHES == 0            # the CPU never counts a launch


def _jax_einsum_frames(q, k, v, scale):
    logits = jnp.einsum("fqhd,fkhd->fhqk", q, k,
                        preferred_element_type=jnp.float32) * scale
    probs = jax.nn.softmax(logits, axis=-1).astype(q.dtype)
    return jnp.einsum("fhqk,fkhd->fqhd", probs, v)


@pytest.mark.parametrize("F,S,H,hd", [(3, 50, 4, 8), (7, 64, 16, 72), (2, 16, 2, 12)])
def test_frame_flash_attention_matches_jax_einsum(rng, F, S, H, hd):
    q, k, v = (rng.randn(F, S, H, hd).astype(np.float32) for _ in range(3))
    want = np.asarray(_jax_einsum_frames(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), hd ** -0.5))
    got = vision_flash.frame_flash_attention(*(torch.from_numpy(t) for t in (q, k, v)),
                                             hd ** -0.5)
    assert got.shape == (F, S, H, hd)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


def test_attn_impl_dispatch():
    cfg = qwen3_vl.QwenVisionConfig()
    assert qwen3_vl.resolve_vision_attn_impl(cfg, torch.zeros(1)) == "einsum"
    for impl in ("flash", "einsum"):
        cfg = qwen3_vl.QwenVisionConfig(attn_impl=impl)
        assert qwen3_vl.resolve_vision_attn_impl(cfg, torch.zeros(1)) == impl
    # JAX's "scan" caps a TPU's memory; the port takes its einsum path
    cfg = qwen3_vl.QwenVisionConfig(attn_impl="scan")
    assert qwen3_vl.resolve_vision_attn_impl(cfg, torch.zeros(1)) == "einsum"


@pytest.mark.parametrize("n_frames", [1, 3])
def test_tower_attn_impl_matches_einsum(n_frames):
    """The port's tower with attn_impl flash (K8's plain version on the CPU)
    equals its einsum path, and both equal JAX's einsum tower."""
    base = dict(depth=2, hidden_size=32, intermediate_size=64, num_heads=4,
                patch_size=4, temporal_patch_size=2, spatial_merge_size=2,
                out_hidden_size=16, num_position_embeddings=64,
                deepstack_visual_indexes=(0,))
    g = 4
    grid = ((1, g, g),) * n_frames
    jcfg = JaxVisionConfig(**base, attn_impl="einsum")
    patches = jax.random.normal(jax.random.PRNGKey(1), (n_frames * g * g, jcfg.patch_dim))
    tower = JaxVisionTower(jcfg)
    params = tower.init(jax.random.PRNGKey(2), patches, grid)["params"]
    want, want_ds, want_taps = tower.apply({"params": params}, patches, grid,
                                           tap_layers=(1,))
    state = params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    x = torch.from_numpy(np.array(patches))
    outs = {}
    for name in ("einsum", "flash"):
        t = qwen3_vl.QwenVisionTower(qwen3_vl.QwenVisionConfig(**base, attn_impl=name),
                                     device="meta")
        t.load_state_dict(state, assign=True)
        with torch.no_grad():
            outs[name] = t(x, grid, tap_layers=(1,))
    for got in (outs["einsum"], outs["flash"]):
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)
        np.testing.assert_allclose(got[1][0].numpy(), np.asarray(want_ds[0]),
                                   atol=2e-5, rtol=2e-5)
        np.testing.assert_allclose(got[2][0].numpy(), np.asarray(want_taps[0]),
                                   atol=2e-5, rtol=2e-5)
