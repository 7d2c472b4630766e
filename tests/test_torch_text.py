"""The port's PubMedBERT text tower against the JAX package's, with the
same params carried across by ``params_from_jax``: ``BertEncoder`` and
``BioMedCLIPTextTower`` in f32 with a padding mask (atol 1e-4), the W8A8
tower (bf16 cast, then ``quantize_params_tree``) against JAX's W8A8 tower
whose projections run the Pallas ``linear_w8a8`` in interpret mode (row
cosine > 0.999, bf16's bound), and the HF / open_clip text converters."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emr2a_tpu.models.clip import BioMedCLIPConfig as JaxBioMedCLIPConfig
from emr2a_tpu.models.clip import BioMedCLIPTextTower as JaxTextTower
from emr2a_tpu.models.convert import convert_biomedclip_text_tower as jax_convert_text
from emr2a_tpu.models.convert import convert_hf_bert as jax_convert_bert
from emr2a_tpu.models.quantize import quantize_params_tree as jax_quantize_tree
from emr2a_tpu.models.text import BertConfig as JaxBertConfig
from emr2a_tpu.models.text import BertEncoder as JaxBertEncoder
from emr2a_tpu.models.vit import ViTConfig as JaxViTConfig
from emr2a_tpu_torch.models.clip import BioMedCLIPConfig, BioMedCLIPTextTower
from emr2a_tpu_torch.models.convert import (
    convert_biomedclip_text_tower,
    convert_hf_bert,
    params_from_jax,
)
from emr2a_tpu_torch.models.layers import Int8Dense, load_params
from emr2a_tpu_torch.models.quantize import quantize_params_tree
from emr2a_tpu_torch.models.text import BertConfig, BertEncoder
from emr2a_tpu_torch.models.vit import ViTConfig
from emr2a_tpu_torch.ops import linear_int8

torch.set_num_threads(1)

BERT = dict(vocab_size=60, max_length=24, hidden_size=64, num_layers=2,
            num_heads=2, mlp_dim=128)
VIT = dict(image_size=32, patch_size=16, hidden_size=64, num_layers=1,
           num_heads=2, mlp_dim=128, pooling="cls")
PROJ = 32


def _ids(rng, B=4, S=16):
    ids = rng.randint(1, BERT["vocab_size"], (B, S))
    mask = np.ones((B, S), np.int64)
    for i, n in enumerate((S, 9, 3, 12)[:B]):   # ragged padding
        ids[i, n:] = 0
        mask[i, n:] = 0
    return ids, mask


@pytest.mark.parametrize("pooling", ["cls", "pooler", "none"])
def test_bert_encoder_matches_jax(rng, pooling):
    jax_bert = JaxBertEncoder(JaxBertConfig(**BERT), pooling=pooling)
    ids, mask = _ids(rng)
    params = jax_bert.init(jax.random.PRNGKey(0), ids, mask)["params"]
    params = jax.tree_util.tree_map(   # non-trivial LayerNorms and biases
        lambda a: a + 0.02 * jax.random.normal(jax.random.PRNGKey(1), a.shape),
        params)
    want = np.asarray(jax_bert.apply({"params": params}, ids, mask))
    bert = BertEncoder(BertConfig(**BERT), pooling=pooling)
    bert.load_state_dict(params_from_jax(jax.device_get(params)))
    with torch.no_grad():
        got = bert(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def _jax_text_tower():
    cfg = JaxBioMedCLIPConfig(vision=JaxViTConfig(**VIT),
                              text=JaxBertConfig(**BERT), projection_dim=PROJ)
    tower = JaxTextTower(cfg)
    params = tower.init(jax.random.PRNGKey(2),
                        jnp.zeros((1, 8), jnp.int32))["params"]
    return cfg, tower, jax.device_get(params)


def _port_config(dtype=torch.float32):
    return BioMedCLIPConfig(vision=ViTConfig(**VIT),
                            text=BertConfig(**BERT, dtype=dtype),
                            projection_dim=PROJ)


def test_biomedclip_text_tower_matches_jax(rng):
    _, tower, params = _jax_text_tower()
    ids, mask = _ids(rng)
    want = np.asarray(tower.apply({"params": params}, ids, mask))
    port = BioMedCLIPTextTower(_port_config())
    port.load_state_dict(params_from_jax(params))
    with torch.no_grad():
        got = port(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    assert got.shape == (4, PROJ)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_int8_text_tower_matches_jax(rng):
    """Both sides cast to bf16 and quantize every BERT projection; every
    one of the port's runs K5 (2 layers x 6 projections per call)."""
    cfg, _, params = _jax_text_tower()
    bf16 = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), params)
    jq = jax_quantize_tree(bf16)
    import dataclasses
    jax_tower = JaxTextTower(dataclasses.replace(
        cfg, text=dataclasses.replace(cfg.text, dtype=jnp.bfloat16)))
    ids, mask = _ids(rng)
    want = np.asarray(jax_tower.apply({"params": jq}, ids, mask), np.float32)

    port = load_params(BioMedCLIPTextTower(_port_config(torch.bfloat16)),
                       params_from_jax(quantize_params_tree(bf16)))
    projs = [m for m in port.modules() if isinstance(m, Int8Dense)]
    assert len(projs) == 2 * 6
    with torch.no_grad():
        got = port(torch.from_numpy(ids), torch.from_numpy(mask)).float().numpy()
    cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1)
                                  * np.linalg.norm(want, axis=-1))
    assert cos.min() > 0.999, cos


def _hf_bert_sd(prefix, seed=3, layers=2, pooler=True):
    r = np.random.RandomState(seed)
    mk = lambda *s: (r.randn(*s) * 0.05).astype(np.float32)
    d, m = BERT["hidden_size"], BERT["mlp_dim"]
    e = prefix + "embeddings."
    sd = {e + "word_embeddings.weight": mk(BERT["vocab_size"], d),
          e + "position_embeddings.weight": mk(BERT["max_length"], d),
          e + "token_type_embeddings.weight": mk(2, d),
          e + "LayerNorm.weight": 1 + mk(d), e + "LayerNorm.bias": mk(d)}
    for i in range(layers):
        p = f"{prefix}encoder.layer.{i}."
        for name, (o, n) in {"attention.self.query": (d, d),
                             "attention.self.key": (d, d),
                             "attention.self.value": (d, d),
                             "attention.output.dense": (d, d),
                             "intermediate.dense": (m, d),
                             "output.dense": (d, m)}.items():
            sd[p + name + ".weight"], sd[p + name + ".bias"] = mk(o, n), mk(o)
        for ln in ("attention.output.LayerNorm", "output.LayerNorm"):
            sd[p + ln + ".weight"], sd[p + ln + ".bias"] = 1 + mk(d), mk(d)
    if pooler:
        sd[prefix + "pooler.dense.weight"] = mk(d, d)
        sd[prefix + "pooler.dense.bias"] = mk(d)
    return sd


def test_hf_bert_converter_matches_jax():
    sd = _hf_bert_sd("")
    want = params_from_jax(jax_convert_bert(sd, num_layers=2))
    got = convert_hf_bert(sd, num_layers=2)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)
    BertEncoder(BertConfig(**BERT), pooling="pooler").load_state_dict(got)


def test_open_clip_text_loader_matches_jax_converter(rng):
    d, h = BERT["hidden_size"], (BERT["hidden_size"] + PROJ) // 2
    sd = _hf_bert_sd("text.transformer.")
    r = np.random.RandomState(4)
    sd["text.proj.0.weight"] = (r.randn(h, d) * 0.1).astype(np.float32)
    sd["text.proj.2.weight"] = (r.randn(PROJ, h) * 0.1).astype(np.float32)
    jax_params = jax_convert_text(sd, num_layers=2)
    got = convert_biomedclip_text_tower(sd, num_layers=2)
    want = params_from_jax(jax_params)
    # the port drops the BERT pooler, which cls pooling never reads
    assert set(want) - set(got) == {"bert.pooler.kernel", "bert.pooler.bias"}
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)
    ids, mask = _ids(rng)
    cfg, tower, _ = _jax_text_tower()
    want_emb = np.asarray(tower.apply({"params": jax_params}, ids, mask))
    port = BioMedCLIPTextTower(_port_config())
    port.load_state_dict(got)
    with torch.no_grad():
        emb = port(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(emb, want_emb, atol=1e-4, rtol=1e-4)


def test_text_tower_int8_projections_count_no_cuda_launch(rng):
    """On the CPU the int8 projections take K5's plain version: the
    kernel's launch count does not move."""
    _, _, params = _jax_text_tower()
    port = load_params(BioMedCLIPTextTower(_port_config()),
                       params_from_jax(quantize_params_tree(params)))
    before = linear_int8.LAUNCHES
    ids, mask = _ids(rng)
    with torch.no_grad():
        out = port(torch.from_numpy(ids), torch.from_numpy(mask))
    assert out.shape == (4, PROJ) and torch.isfinite(out).all()
    assert linear_int8.LAUNCHES == before
