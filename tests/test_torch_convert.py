"""open_clip BiomedCLIP image-tower loading: the port's converter against
the JAX package's ``convert_biomedclip_image_tower`` on one synthetic
open_clip-layout state dict (timm ``visual.trunk.*`` keys with fused qkv
and ``visual.head.proj``), plus the state-dict file reader."""

import jax
import numpy as np
import pytest
import torch

from emr2a_tpu.models.clip import BioMedCLIPConfig as JaxBioMedCLIPConfig
from emr2a_tpu.models.clip import BioMedCLIPImageTower as JaxImageTower
from emr2a_tpu.models.convert import (
    convert_biomedclip_image_tower as jax_convert,
)
from emr2a_tpu.models.vit import ViTConfig as JaxViTConfig
from emr2a_tpu_torch.models.clip import BioMedCLIPConfig, BioMedCLIPImageTower
from emr2a_tpu_torch.models.convert import (
    convert_biomedclip_image_tower,
    load_state_dict,
    params_from_jax,
)
from emr2a_tpu_torch.models.vit import ViTConfig

torch.set_num_threads(1)

D, LAYERS, PROJ = 64, 2, 32
TINY = dict(image_size=32, patch_size=16, hidden_size=D, num_layers=LAYERS,
            num_heads=2, mlp_dim=128, ln_eps=1e-6, pooling="cls")


def _open_clip_image_sd(seed=7):
    """numpy state dict in open_clip's BiomedCLIP image layout."""
    r = np.random.RandomState(seed)
    mk = lambda *sh: (r.randn(*sh) * 0.05).astype(np.float32)
    t = "visual.trunk."
    sd = {
        t + "cls_token": mk(1, 1, D),
        t + "pos_embed": mk(1, 5, D),
        t + "patch_embed.proj.weight": mk(D, 3, 16, 16),
        t + "patch_embed.proj.bias": mk(D),
        t + "norm.weight": 1 + mk(D),
        t + "norm.bias": mk(D),
        "visual.head.proj.weight": mk(PROJ, D),
    }
    for i in range(LAYERS):
        p = f"{t}blocks.{i}."
        sd.update({
            p + "norm1.weight": 1 + mk(D), p + "norm1.bias": mk(D),
            p + "attn.qkv.weight": mk(3 * D, D), p + "attn.qkv.bias": mk(3 * D),
            p + "attn.proj.weight": mk(D, D), p + "attn.proj.bias": mk(D),
            p + "norm2.weight": 1 + mk(D), p + "norm2.bias": mk(D),
            p + "mlp.fc1.weight": mk(128, D), p + "mlp.fc1.bias": mk(128),
            p + "mlp.fc2.weight": mk(D, 128), p + "mlp.fc2.bias": mk(D),
        })
    return sd


def _port_tower(state):
    tower = BioMedCLIPImageTower(BioMedCLIPConfig(vision=ViTConfig(**TINY),
                                                  projection_dim=PROJ))
    tower.load_state_dict(state)
    return tower


def test_open_clip_image_loader_matches_jax_converter(rng):
    sd = _open_clip_image_sd()
    jax_params = jax_convert(sd, num_layers=LAYERS)
    port_state = convert_biomedclip_image_tower(sd, num_layers=LAYERS)
    assert port_state.keys() == params_from_jax(jax_params).keys()
    for k, v in params_from_jax(jax_params).items():
        np.testing.assert_array_equal(port_state[k].numpy(), v.numpy(), err_msg=k)

    pixels = rng.randn(2, 32, 32, 3).astype(np.float32)
    jax_tower = JaxImageTower(JaxBioMedCLIPConfig(
        vision=JaxViTConfig(**TINY), text=None, projection_dim=PROJ))
    want = np.asarray(jax_tower.apply({"params": jax_params}, pixels))
    with torch.no_grad():
        got = _port_tower(port_state)(torch.from_numpy(pixels)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_bare_proj_parameter_converts_identically():
    sd = _open_clip_image_sd()
    alt = {k: v for k, v in sd.items() if k != "visual.head.proj.weight"}
    alt["visual.proj"] = sd["visual.head.proj.weight"].T
    a = convert_biomedclip_image_tower(sd, num_layers=LAYERS)
    b = convert_biomedclip_image_tower(alt, num_layers=LAYERS)
    torch.testing.assert_close(a["head_proj.kernel"], b["head_proj.kernel"],
                               atol=0, rtol=0)


@pytest.mark.parametrize("fmt", ["bin", "safetensors", "dir"])
def test_state_dict_files_round_trip(tmp_path, fmt):
    sd = _open_clip_image_sd()
    tensors = {k: torch.from_numpy(v) for k, v in sd.items()}
    if fmt == "safetensors":
        from safetensors.torch import save_file
        path = tmp_path / "model.safetensors"
        save_file(tensors, str(path))
    elif fmt == "bin":
        path = tmp_path / "weights.bin"
        torch.save({"state_dict": tensors}, path)
    else:
        path = tmp_path
        torch.save(tensors, tmp_path / "open_clip_pytorch_model.bin")
    loaded = load_state_dict(path)
    assert loaded.keys() == sd.keys()
    for k in sd:
        np.testing.assert_array_equal(loaded[k], sd[k])


def test_params_from_jax_accepts_bf16_trees():
    """A JAX fast-mode tree holds bf16 (ml_dtypes) leaves."""
    tree = {"block_0": {"ln1": {"scale": np.ones(4, np.float32)}},
            "head_proj": {"kernel": np.arange(6, dtype=np.float32).reshape(2, 3)}}
    bf16 = jax.tree_util.tree_map(
        lambda a: np.asarray(jax.numpy.asarray(a, jax.numpy.bfloat16)), tree)
    state = params_from_jax(bf16)
    assert set(state) == {"blocks.0.ln1.weight", "head_proj.kernel"}
    assert state["head_proj.kernel"].dtype == torch.bfloat16
    torch.testing.assert_close(state["head_proj.kernel"].float(),
                               torch.arange(6.0).reshape(2, 3))
