"""The port's int8 recipes against the JAX package's, bit for bit: the
per-row activation quantize (``ops/quant.quantize_rows_s8``), the
per-column weight quantize (``ops/mlp.quantize_weight_int8``), and the
W8A8 param trees of ``models/quantize.py`` on a tiny tower cast to bf16
first, as ``fast="int8"`` does."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emr2a_tpu.models.clip import BioMedCLIPConfig as JaxBioMedCLIPConfig
from emr2a_tpu.models.clip import BioMedCLIPImageTower as JaxImageTower
from emr2a_tpu.models.clip import BioMedCLIPTextTower as JaxTextTower
from emr2a_tpu.models.quantize import quantize_params_tree as jax_quantize_tree
from emr2a_tpu.models.quantize import quantize_tower_params as jax_quantize_tower
from emr2a_tpu.models.text import BertConfig as JaxBertConfig
from emr2a_tpu.models.vit import ViTConfig as JaxViTConfig
from emr2a_tpu.ops.mlp import quantize_weight_int8 as jax_quantize_weight
from emr2a_tpu.ops.quant import quantize_rows_s8 as jax_quantize_rows
from emr2a_tpu_torch.models.convert import params_from_jax, params_to_jax
from emr2a_tpu_torch.models.quantize import (
    quantize_block_params,
    quantize_params_tree,
    quantize_tower_params,
)
from emr2a_tpu_torch.ops.mlp import quantize_weight_int8
from emr2a_tpu_torch.ops.quant import quantize_rows_s8, quantize_rows_s8_reference

torch.set_num_threads(1)


def _tie_row(rng, K):
    """A row in which most elements land exactly on k + 0.5 after the
    multiply by 1/scale (its amax element is kept)."""
    row = rng.randn(K).astype(np.float32)
    amax = np.abs(row).max()
    scale = np.float32(max(amax, np.float32(1e-12)) * np.float32(1.0 / 127.0))
    inv = np.float32(1.0) / scale
    half = (rng.randint(-120, 120, K) + 0.5).astype(np.float32)
    cand = (half / inv).astype(np.float32)
    ties = (cand * inv) == half
    ties[np.argmax(np.abs(row))] = False
    return np.where(ties, cand, row), int(ties.sum())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_rows_s8_codes_equal_jax(rng, dtype):
    K = 256
    x = (rng.randn(64, K) * np.exp(rng.randn(64, 1) * 3)).astype(np.float32)
    x[3] = 0.0                                  # zero row: scale 1e-12/127
    x[4] *= 1e30                                # large magnitudes
    x[5] *= 1e-30
    x[6], n_ties = _tie_row(rng, K)
    assert n_ties > K // 2
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want_q, want_s = jax_quantize_rows(jnp.asarray(x, jdt))
    got_q, got_s = quantize_rows_s8(torch.from_numpy(x).to(tdt))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    assert got_q.shape == (64, K) and got_s.shape == (64, 1)
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy().view(np.int32),
                                  np.asarray(want_s).view(np.int32))
    assert (got_q[3] == 0).all() and got_s[3, 0] == np.float32(1e-12) * np.float32(1 / 127)


def test_quantize_rows_keeps_leading_axes(rng):
    x = torch.from_numpy(rng.randn(2, 3, 32).astype(np.float32))
    q, s = quantize_rows_s8_reference(x)
    assert q.shape == (2, 3, 32) and s.shape == (2, 3, 1)
    q2, s2 = quantize_rows_s8_reference(x.reshape(6, 32))
    torch.testing.assert_close(q.reshape(6, 32), q2, atol=0, rtol=0)


def test_quantize_weight_int8_equals_jax(rng):
    w = (rng.randn(96, 160) * 0.05).astype(np.float32)
    w[:, 7] = 0.0                               # zero column: scale 1e-12
    w[:, 9] = np.round(w[:, 9] * 100) / 100
    q, s = quantize_weight_int8(w)
    want_q, want_s = jax_quantize_weight(w)
    assert q.dtype == np.int8 and s.shape == (1, 160) and s.dtype == np.float32
    np.testing.assert_array_equal(q, want_q)
    np.testing.assert_array_equal(s.view(np.int32), want_s.view(np.int32))


def _jax_tree():
    """A tiny BioMedCLIP param tree (image and text), cast to bf16 as the
    encoder's fast="int8" does before it quantizes."""
    cfg = JaxBioMedCLIPConfig(
        vision=JaxViTConfig(image_size=32, patch_size=16, hidden_size=64,
                            num_layers=2, num_heads=2, mlp_dim=128,
                            pooling="cls"),
        text=JaxBertConfig(vocab_size=50, max_length=16, hidden_size=64,
                           num_layers=2, num_heads=2, mlp_dim=128),
        projection_dim=32)
    key = jax.random.PRNGKey(0)
    tree = {"image": JaxImageTower(cfg).init(key, jnp.zeros((1, 32, 32, 3)))["params"],
            "text": JaxTextTower(cfg).init(key, jnp.zeros((1, 8), jnp.int32))["params"]}
    return jax.device_get(jax.tree_util.tree_map(
        lambda a: a.astype(jnp.bfloat16), tree))


def _assert_same_tree(got, want, path=""):
    assert sorted(got) == sorted(want), path
    for k in want:
        if isinstance(want[k], dict):
            _assert_same_tree(got[k], want[k], f"{path}/{k}")
        else:
            g, w = got[k], np.asarray(want[k])
            if isinstance(g, torch.Tensor):             # bf16 has no numpy view
                assert str(g.dtype).split(".")[-1] == w.dtype.name, f"{path}/{k}"
                g = (g.view(torch.int16) if g.dtype == torch.bfloat16 else g).numpy()
            else:
                assert g.dtype == w.dtype, f"{path}/{k}"
            assert g.shape == w.shape, f"{path}/{k}"
            assert g.tobytes() == w.tobytes(), f"{path}/{k}"


def test_quantized_trees_byte_identical_to_jax():
    tree = _jax_tree()
    want = {"image": {**tree["image"],
                      "trunk": jax_quantize_tower(tree["image"]["trunk"])},
            "text": jax_quantize_tree(tree["text"])}
    got = {"image": {**tree["image"],
                     "trunk": quantize_tower_params(tree["image"]["trunk"])},
           "text": quantize_params_tree(tree["text"])}
    _assert_same_tree(got, want)
    blk = got["text"]["bert"]["block_1"]
    assert blk["attn"]["out_proj"]["kernel_q"].dtype == np.int8
    assert blk["mlp"]["fc1"]["kernel_scale"].shape == (128,)
    assert "kernel" in got["text"]["proj_fc1"]          # heads stay float
    assert "kernel" in got["image"]["trunk"]["patch_embed"]


def test_quantize_from_torch_leaves_and_dinov3_names():
    """The encoder quantizes a state dict nested by ``params_to_jax``
    (torch leaves); DINOv3's projection names are covered too."""
    tree = _jax_tree()
    state = params_from_jax(tree)
    assert all(isinstance(v, torch.Tensor) for v in state.values())
    nested = params_to_jax(state)
    _assert_same_tree(quantize_params_tree(nested)["text"],
                      jax_quantize_tree(tree["text"]))
    assert params_from_jax(nested).keys() == state.keys()
    w = np.random.RandomState(1).randn(8, 16).astype(np.float32)
    block = {"attn": {"o_proj": {"kernel": w}},
             "mlp": {n: {"kernel": w.T, "bias": np.ones(8)}
                     for n in ("gate_proj", "up_proj", "down_proj")}}
    out = quantize_block_params(block)
    assert out["attn"]["o_proj"]["kernel_q"].shape == (8, 16)
    assert set(out["mlp"]["up_proj"]) == {"kernel_q", "kernel_scale", "bias"}
