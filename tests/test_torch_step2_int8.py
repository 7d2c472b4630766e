"""The slice end to end at a tiny size: step2 with ``fast="int8"`` (W8A8
image trunk: K4 and K2 in every block) and ``encode_batch_texts`` (the
PubMedBERT tower, W8A8 projections on K5) through the port's BioMedCLIP
encoder against the JAX package's, on the same params carried across by
``params_from_jax``. JAX returns bf16 rows normalised in bf16, the port f32
rows, so the int8 bound is bf16's: row cosine >= 0.999."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emr2a_tpu.encoders.biomedclip_encoder import (
    BioMedCLIPEncoder as JaxBioMedCLIPEncoder,
)
from emr2a_tpu.models.clip import BioMedCLIPConfig as JaxBioMedCLIPConfig
from emr2a_tpu.models.clip import BioMedCLIPImageTower as JaxImageTower
from emr2a_tpu.models.clip import BioMedCLIPTextTower as JaxTextTower
from emr2a_tpu.models.text import BertConfig as JaxBertConfig
from emr2a_tpu.models.vit import ViTConfig as JaxViTConfig
from emr2a_tpu.pipelines.step2_embeddings import build_embeddings as jax_step2
from emr2a_tpu_torch.encoders import factory
from emr2a_tpu_torch.encoders.biomedclip_encoder import BioMedCLIPEncoder
from emr2a_tpu_torch.models.clip import BioMedCLIPConfig
from emr2a_tpu_torch.models.convert import params_from_jax
from emr2a_tpu_torch.models.layers import Int8Dense
from emr2a_tpu_torch.models.text import BertConfig
from emr2a_tpu_torch.models.vit import ViTConfig
from emr2a_tpu_torch.pipelines.step2_embeddings import build_embeddings as step2

torch.set_num_threads(1)

# patch 32 at 224 px: 50 tokens, padded to 56 on the fused path
VIT = dict(image_size=224, patch_size=32, hidden_size=64, num_layers=2,
           num_heads=2, mlp_dim=128, ln_eps=1e-6, pooling="cls")
BERT = dict(vocab_size=64, max_length=16, hidden_size=64, num_layers=2,
            num_heads=2, mlp_dim=128)
PROJ = 32
TEXTS = ["PJP, bilateral ground-glass opacities", "case 1", "",
         "Viral pneumonia; fever 39.1 C, cough", "normal chest CT"]


class _BertTok:
    """The stub tokenizer of ``tests/test_encoders.py``: [CLS]=2, one id per
    character, [SEP]=1, padding 0."""

    def __call__(self, texts, **kw):
        n = kw.get("max_length", 16)
        ids = np.zeros((len(texts), n), np.int64)
        for i, t in enumerate(texts):
            toks = [2] + [3 + (ord(c) % 60) for c in t[:n - 2]] + [1]
            ids[i, :len(toks)] = toks
        return {"input_ids": ids,
                "attention_mask": (ids != 0).astype(np.int64)}


@pytest.fixture(scope="module")
def jax_params():
    cfg = JaxBioMedCLIPConfig(vision=JaxViTConfig(**VIT),
                              text=JaxBertConfig(**BERT), projection_dim=PROJ)
    key = jax.random.PRNGKey(0)
    return jax.device_get({
        "image": JaxImageTower(cfg).init(key, jnp.zeros((1, 224, 224, 3)))["params"],
        "text": JaxTextTower(cfg).init(key, jnp.zeros((1, 8), jnp.int32))["params"]})


def _encoders(params, fast):
    jax_enc = JaxBioMedCLIPEncoder(
        config=JaxBioMedCLIPConfig(vision=JaxViTConfig(**VIT),
                                   text=JaxBertConfig(**BERT),
                                   projection_dim=PROJ),
        params=params, tokenizer=_BertTok(), context_length=16, device="cpu",
        fast=fast)
    port_enc = BioMedCLIPEncoder(
        config=BioMedCLIPConfig(vision=ViTConfig(**VIT), text=BertConfig(**BERT),
                                projection_dim=PROJ),
        params=params_from_jax(params), tokenizer=_BertTok(),
        context_length=16, device="cpu", fast=fast)
    return jax_enc, port_enc


def _cosine(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                              * np.linalg.norm(b, axis=-1))


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    """3 patients x 3 slices of mixed sizes."""
    from PIL import Image
    root = tmp_path_factory.mktemp("cohort_int8")
    rng = np.random.RandomState(11)
    manifest = []
    for p in range(3):
        slices = []
        for s, (h, w) in enumerate([(224, 224), (300, 260), (256, 256)]):
            yy, xx = np.mgrid[0:h, 0:w]
            base = 128 + 90 * np.sin((xx + 9 * p) / 19.0) * np.cos(yy / 27.0)
            img = np.clip(base[..., None] + rng.randn(h, w, 3) * 25, 0, 255)
            path = root / f"p{p}_s{s}.png"
            Image.fromarray(img.astype(np.uint8)).save(path)
            slices.append(str(path))
        manifest.append({"patient_id": f"P{p:03d}", "slices": slices})
    return root, manifest


def test_step2_fast_int8_matches_jax(cohort, jax_params, tmp_path):
    root, manifest = cohort
    jax_enc, port_enc = _encoders(jax_params, fast="int8")
    paths = step2.load_images(manifest, root)
    want = jax_step2.encode_images(jax_enc, paths, batch_size=4)
    got = step2.encode_images(port_enc, paths, batch_size=4)
    assert list(got) == list(want) == ["P000", "P001", "P002"]
    for pid in want:
        assert got[pid].shape == (3, PROJ) and got[pid].dtype == np.float32
        cos = _cosine(got[pid], want[pid])
        assert cos.min() >= 0.999, (pid, cos)
    step2.save_embeddings(got, tmp_path)
    meta = json.loads((tmp_path / "embeddings_meta.json").read_text())
    assert meta == {"num_patients": 3, "patients": ["P000", "P001", "P002"],
                    "embedding_dim": PROJ}


def test_fast_int8_routes_every_block_to_w8a8(jax_params):
    _, port_enc = _encoders(jax_params, fast="int8")
    trunk = port_enc.image_model.trunk
    assert all(b.fused_attn and b.fused_mlp for b in trunk.blocks)
    for b in trunk.blocks:
        for proj in (b.attn.q_proj, b.attn.k_proj, b.attn.v_proj,
                     b.attn.out_proj, b.mlp.fc1, b.mlp.fc2):
            assert isinstance(proj, Int8Dense) and proj.bias.dtype == torch.bfloat16
    text = port_enc.text_model
    assert sum(isinstance(m, Int8Dense) for m in text.modules()) == 6 * 2
    assert not isinstance(text.proj_fc1, Int8Dense)   # the head stays bf16
    assert port_enc.image_model.head_proj.kernel.dtype == torch.bfloat16


@pytest.mark.parametrize("fast", [False, "int8"])
def test_encode_batch_texts_matches_jax(jax_params, fast):
    jax_enc, port_enc = _encoders(jax_params, fast=fast)
    want = jax_enc.encode_batch_texts(TEXTS)
    got = port_enc.encode_batch_texts(TEXTS)
    assert len(got) == len(want) == len(TEXTS)
    got, want = np.stack(got), np.stack([np.asarray(w, np.float32) for w in want])
    assert got.shape == (len(TEXTS), PROJ) and got.dtype == np.float32
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)
    if fast:
        assert _cosine(got, want).min() >= 0.999
    else:
        np.testing.assert_allclose(got, want, atol=1e-4)
    assert port_enc.encode_batch_texts([]) == []
    port_enc.max_batch = 2                      # chunked: same rows
    np.testing.assert_allclose(np.stack(port_enc.encode_batch_texts(TEXTS)),
                               got, atol=1e-6)


def test_step2_cli_and_factory_pass_fast_int8_and_tokenizer(monkeypatch, tmp_path):
    """``--fast int8`` reaches the encoder as fast="int8"; the factory hands
    ``tokenizer`` to BioMedCLIPEncoder."""
    seen = {}

    def fake_create(**kw):
        seen.update(kw)
        return factory.create_encoder("fake", device="cpu")

    monkeypatch.setattr(step2, "create_encoder", fake_create)
    manifest = tmp_path / "manifest.jsonl"
    manifest.write_text("", encoding="utf-8")
    step2.main(["--manifest_path", str(manifest), "--encoder_type",
                "biomedclip", "--fast", "int8", "--device", "cpu",
                "--output_dir", str(tmp_path / "out")])
    assert seen["fast"] == "int8" and seen["encoder_type"] == "biomedclip"

    made = {}
    monkeypatch.setattr(factory, "BioMedCLIPEncoder",
                        lambda **kw: made.update(kw) or "encoder")
    tok = _BertTok()
    assert factory.create_encoder("biomedclip", fast="int8", tokenizer=tok,
                                  model_path="ckpt") == "encoder"
    assert made["tokenizer"] is tok and made["fast"] == "int8"
    assert made["model_path"] == "ckpt"
