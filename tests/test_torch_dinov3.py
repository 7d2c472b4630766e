"""The port's DINOv3 (``models/dinov3.py``, ``encoders/dino_encoder.py``) on
the CPU, against transformers' random-init ``DINOv3ViTModel`` and the JAX
package, with the weights converted by both packages from one state dict.

Tolerances, the reference's (``tests/test_dinov3_parity.py``): atol 3e-4,
rtol 1e-3 for the f32 tower, with and without the gated MLP and registers;
the W8A8 tower within row cosine 0.995 of the float one, and within 0.999
of JAX's W8A8 tower; ``fast`` (bf16) embeddings within row cosine 0.999.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import emr2a_tpu.models.dinov3 as jd
from emr2a_tpu.models.quantize import quantize_params_tree as jax_quantize
from emr2a_tpu_torch.models import dinov3 as pd
from emr2a_tpu_torch.models.convert import params_from_jax, params_to_jax
from emr2a_tpu_torch.models.layers import Int8Dense, load_params

torch.set_num_threads(1)
transformers = pytest.importorskip("transformers")


def hf_dinov3(gated: bool, registers: int, seed: int = 0):
    from transformers import DINOv3ViTConfig, DINOv3ViTModel
    hcfg = DINOv3ViTConfig(
        hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
        intermediate_size=128, image_size=32, patch_size=16,
        num_register_tokens=registers, use_gated_mlp=gated,
        rope_theta=100.0, attn_implementation="eager")
    torch.manual_seed(seed)
    model = DINOv3ViTModel(hcfg).eval()
    return model, hcfg, {k: v.detach().numpy() for k, v in model.state_dict().items()}


def configs(gated, registers):
    kw = dict(image_size=32, patch_size=16, hidden_size=64, num_layers=2, num_heads=2,
              mlp_dim=128, num_register_tokens=registers, use_gated_mlp=gated,
              rope_theta=100.0)
    return jd.DINOv3Config(**kw), pd.DINOv3Config(**kw)


def cosines(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


@pytest.mark.parametrize("gated,registers", [(False, 0), (True, 2), (False, 4), (True, 0)])
def test_dinov3_tower_matches_hf_and_jax(rng, gated, registers):
    model, _, sd = hf_dinov3(gated, registers)
    jcfg, pcfg = configs(gated, registers)
    tower = load_params(pd.DINOv3ViT(pcfg), pd.convert_hf_dinov3(sd, 2))
    pixels = rng.randn(2, 32, 32, 3).astype(np.float32)
    with torch.no_grad():
        hf = model(torch.tensor(pixels.transpose(0, 3, 1, 2))).last_hidden_state.numpy()
        got = tower(torch.from_numpy(pixels)).numpy()
    want = np.asarray(jd.DINOv3ViT(jcfg).apply(
        {"params": jd.convert_hf_dinov3(sd, num_layers=2)}, pixels))
    assert got.shape == (2, 1 + registers + 4, 64)
    np.testing.assert_allclose(got, hf, atol=3e-4, rtol=1e-3)
    np.testing.assert_allclose(got, want, atol=3e-4, rtol=1e-3)


@pytest.mark.parametrize("pooling", ["mean_all", "cls"])
def test_dinov3_pooling_matches_jax(rng, pooling):
    _, _, sd = hf_dinov3(False, 2, seed=1)
    jcfg, pcfg = configs(False, 2)
    tower = load_params(pd.DINOv3ViT(pcfg, pooling=pooling), pd.convert_hf_dinov3(sd, 2))
    pixels = rng.randn(3, 32, 32, 3).astype(np.float32)
    want = np.asarray(jd.DINOv3ViT(jcfg, pooling=pooling).apply(
        {"params": jd.convert_hf_dinov3(sd, num_layers=2)}, pixels))
    with torch.no_grad():
        got = tower(torch.from_numpy(pixels)).numpy()
    assert got.shape == (3, 64)
    np.testing.assert_allclose(got, want, atol=3e-4, rtol=1e-3)


def test_rope_tables_and_params_round_trip(rng):
    for args in ((2, 2, 32, 100.0), (14, 14, 64, 100.0), (3, 5, 16, 10.0)):
        for got, want in zip(pd.rope_angles(*args), jd.rope_angles(*args)):
            np.testing.assert_array_equal(got, np.asarray(want))
    _, _, sd = hf_dinov3(True, 2)
    jtree = jd.convert_hf_dinov3(sd, num_layers=2)
    state = pd.convert_hf_dinov3(sd, 2)
    assert set(state) == set(params_from_jax(jtree))
    assert {"register_tokens", "blocks.1.layer_scale2", "blocks.0.mlp.gate_proj.kernel",
            "blocks.0.norm1.weight", "final_ln.bias"} <= set(state)
    again = params_from_jax(params_to_jax(state))
    assert all(torch.equal(again[k], v) for k, v in state.items())
    flat = jax.tree_util.tree_leaves_with_path(jtree)
    back = params_to_jax(state)
    for path, leaf in flat:
        node = back
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node.numpy(), leaf)


def test_quantized_dinov3_runs_every_projection_w8a8(rng):
    """W8A8 params from both packages' quantizers (byte-identical trees):
    every block projection becomes an ``Int8Dense`` (the streaming W8A8
    op); the tower tracks the float one and JAX's W8A8 tower."""
    jcfg, pcfg = configs(True, 2)
    jcfg, pcfg = (dataclasses.replace(c, num_heads=4) for c in (jcfg, pcfg))
    tower = jd.DINOv3ViT(jcfg, pooling="mean_all")
    x = rng.randn(2, 32, 32, 3).astype(np.float32) * 0.5
    params = jax.device_get(tower.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    qtree = jax_quantize(params)
    from emr2a_tpu_torch.models.quantize import quantize_params_tree
    state = params_from_jax(quantize_params_tree(params_to_jax(params_from_jax(params))))
    want_state = params_from_jax(qtree)
    assert set(state) == set(want_state)
    assert all(torch.equal(state[k], v) for k, v in want_state.items())
    port = load_params(pd.DINOv3ViT(pcfg, pooling="mean_all"), state)
    assert sum(isinstance(m, Int8Dense) for m in port.modules()) == 2 * 7
    float_port = load_params(pd.DINOv3ViT(pcfg, pooling="mean_all"), params_from_jax(params))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
        ref = float_port(torch.from_numpy(x)).numpy()
    want = np.asarray(tower.apply({"params": qtree}, x))
    assert cosines(got, ref).min() > 0.995
    assert cosines(got, want).min() > 0.999


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    model, _, _ = hf_dinov3(True, 2, seed=3)
    path = tmp_path_factory.mktemp("dinov3")
    model.save_pretrained(path)
    return path


@pytest.mark.parametrize("fast", [False, True, "int8"])
def test_dino_encoder_matches_jax(hf_dir, fast):
    """Both packages' encoders from one ``save_pretrained`` directory:
    mean over every token, L2-normalised; text gives None."""
    from emr2a_tpu.encoders.dino_encoder import DINOEncoder as JaxDINO
    from emr2a_tpu.encoders.dino_encoder import dinov3_config_from_hf as jax_cfg
    from emr2a_tpu_torch.encoders.dino_encoder import DINOEncoder, dinov3_config_from_hf
    import json
    hf = json.loads((hf_dir / "config.json").read_text())
    assert dataclasses.asdict(dinov3_config_from_hf(hf)) == {
        **dataclasses.asdict(jax_cfg(hf)), "dtype": torch.float32}
    r = np.random.RandomState(2)
    imgs = [(r.rand(h, w, 3) * 255).astype(np.uint8) for h, w in ((224, 224), (300, 260))]
    jax_enc = JaxDINO(model_path=str(hf_dir), device="cpu", fast=fast)
    port = DINOEncoder(model_path=str(hf_dir), device="cpu", fast=fast)
    got = np.stack(port.encode_batch_images(imgs))
    want = np.stack([np.asarray(w, np.float32) for w in jax_enc.encode_batch_images(imgs)])
    assert got.shape == (2, 64) and got.dtype == np.float32
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1, atol=1e-5)
    if fast:
        assert cosines(got, want).min() >= 0.999
    else:
        np.testing.assert_allclose(got, want, atol=3e-4, rtol=1e-3)
    assert port.encode_text("x") is None and port.encode_batch_texts(["a", "b"]) == [None, None]
    n_int8 = sum(isinstance(m, Int8Dense) for m in port.image_model.modules())
    assert n_int8 == (2 * 7 if fast == "int8" else 0)


def test_dino_encoder_random_init_is_seeded():
    from emr2a_tpu_torch.encoders.dino_encoder import DINOEncoder
    cfg = pd.DINOv3Config(hidden_size=64, num_layers=1, num_heads=2, mlp_dim=128)
    a, b = (DINOEncoder(config=cfg, device="cpu").image_model.state_dict() for _ in range(2))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert a["blocks.0.layer_scale1"].eq(1).all() and a["register_tokens"].std() > 0.01
