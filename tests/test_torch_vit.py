"""The port's ViT / BioMedCLIP image tower against the JAX package's, with
the same params carried across by ``params_from_jax``: the fused path
against the JAX fused kernels (interpret mode off the TPU), the unfused
path against the JAX einsum path (exact erf gelu)."""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emr2a_tpu.models.clip import BioMedCLIPConfig as JaxBioMedCLIPConfig
from emr2a_tpu.models.clip import BioMedCLIPImageTower as JaxImageTower
from emr2a_tpu.models.vit import ViTConfig as JaxViTConfig
from emr2a_tpu.models.vit import VisionTransformer as JaxVisionTransformer
from emr2a_tpu_torch.models.clip import BioMedCLIPConfig, BioMedCLIPImageTower
from emr2a_tpu_torch.models.convert import params_from_jax
from emr2a_tpu_torch.models.vit import ViTConfig, VisionTransformer

torch.set_num_threads(1)

TINY = dict(image_size=32, patch_size=16, hidden_size=64, num_layers=2,
            num_heads=2, mlp_dim=128, ln_eps=1e-6, pooling="cls")


def _pixels(rng, B=3):
    return rng.randn(B, 32, 32, 3).astype(np.float32)


@pytest.mark.parametrize("fused", [True, False])
def test_biomedclip_image_tower_matches_jax(rng, fused):
    flags = dict(fused_mlp=fused, fused_attn=fused)
    jax_cfg = JaxBioMedCLIPConfig(vision=JaxViTConfig(**TINY, **flags),
                                  text=None, projection_dim=32)
    jax_tower = JaxImageTower(jax_cfg)
    params = jax_tower.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 32, 3)))["params"]
    pixels = _pixels(rng)
    want = np.asarray(jax_tower.apply({"params": params}, pixels))

    tower = BioMedCLIPImageTower(BioMedCLIPConfig(
        vision=ViTConfig(**TINY, **flags), projection_dim=32))
    tower.load_state_dict(params_from_jax(jax.device_get(params)))
    with torch.no_grad():
        got = tower(torch.from_numpy(pixels)).numpy()
    assert got.shape == (3, 32)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("pooling,pre_ln", [
    ("cls_ln", True), ("mean", False), ("avg_fc_norm", False), ("none", False),
])
@pytest.mark.parametrize("fused", [True, False])
def test_vit_poolings_match_jax(rng, pooling, pre_ln, fused):
    cfg = {**TINY, "pooling": pooling, "use_pre_layernorm": pre_ln,
           "activation": "quick_gelu" if pre_ln else "gelu",
           "fused_mlp": fused, "fused_attn": fused}
    jax_vit = JaxVisionTransformer(JaxViTConfig(**cfg))
    params = jax_vit.init(jax.random.PRNGKey(1),
                          jnp.zeros((1, 32, 32, 3)))["params"]
    pixels = _pixels(rng, B=2)
    want = np.asarray(jax_vit.apply({"params": params}, pixels))

    vit = VisionTransformer(ViTConfig(**cfg))
    vit.load_state_dict(params_from_jax(jax.device_get(params)))
    with torch.no_grad():
        got = vit(torch.from_numpy(pixels)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_fast_flags_pad_tokens_once(rng):
    """With fused attention the 5 tokens (4 patches + cls) are padded to 8
    and every block sees valid_len 5; the result equals the unpadded
    unfused tower up to the tanh-gelu substitution."""
    seen = []
    vit = VisionTransformer(ViTConfig(**TINY, fused_attn=True))
    for block in vit.blocks:
        block.register_forward_hook(
            lambda mod, args, kwargs, out: seen.append(
                (args[0].shape[1], kwargs.get("valid_len"))),
            with_kwargs=True)
    plain = VisionTransformer(ViTConfig(**TINY))
    with torch.no_grad():
        for p in vit.parameters():
            p.normal_(0, 0.05)
        plain.load_state_dict(vit.state_dict())
        x = torch.from_numpy(_pixels(rng))
        np.testing.assert_allclose(vit(x).numpy(), plain(x).numpy(),
                                   atol=1e-5, rtol=1e-5)
    assert seen == [(8, 5), (8, 5)]
