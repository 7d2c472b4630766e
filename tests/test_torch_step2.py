"""The step2 slice end to end: a synthetic cohort of PNG slices on disk
(mixed sizes) through both packages' BioMedCLIP encoders and the step2
``encode_images`` / ``save_embeddings``, and the port's step2 CLI with the
fake encoder against the JAX package's."""

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
from emr2a_tpu.models.vit import ViTConfig as JaxViTConfig
from emr2a_tpu.pipelines.step2_embeddings import build_embeddings as jax_step2
from emr2a_tpu_torch.encoders.biomedclip_encoder import BioMedCLIPEncoder
from emr2a_tpu_torch.models.clip import BioMedCLIPConfig
from emr2a_tpu_torch.models.convert import params_from_jax
from emr2a_tpu_torch.models.vit import ViTConfig
from emr2a_tpu_torch.pipelines.step2_embeddings import build_embeddings as step2

torch.set_num_threads(1)

# BioMedCLIP preprocessing crops 224 px; patch 32 keeps the tower small
# while its 50 tokens still take the pad-to-8 / valid_len path.
TINY = dict(image_size=224, patch_size=32, hidden_size=64, num_layers=2,
            num_heads=2, mlp_dim=128, ln_eps=1e-6, pooling="cls")
PROJ = 32
SIZES = [(224, 224), (256, 256), (300, 260), (512, 512)]


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    """3 patients x 5 slices of mixed sizes, and their manifest records."""
    from PIL import Image
    root = tmp_path_factory.mktemp("cohort")
    rng = np.random.RandomState(3)
    manifest = []
    for p in range(3):
        slices = []
        for s in range(5):
            h, w = SIZES[(p + s) % len(SIZES)]
            yy, xx = np.mgrid[0:h, 0:w]
            base = 128 + 100 * np.sin((xx + 7 * p) / 23.0) * np.cos(yy / 31.0)
            img = np.clip(base[..., None] + rng.randn(h, w, 3) * 20, 0, 255)
            path = root / f"p{p}_s{s}.png"
            Image.fromarray(img.astype(np.uint8)).save(path)
            slices.append(str(path))
        manifest.append({"patient_id": f"P{p:03d}", "label": "Viral",
                         "slices": slices})
    (root / "manifest.jsonl").write_text(
        "".join(json.dumps(r) + "\n" for r in manifest), encoding="utf-8")
    return root, manifest


@pytest.fixture(scope="module")
def jax_image_params():
    cfg = JaxBioMedCLIPConfig(vision=JaxViTConfig(**TINY), text=None,
                              projection_dim=PROJ)
    params = JaxImageTower(cfg).init(jax.random.PRNGKey(0),
                                     jnp.zeros((1, 224, 224, 3)))["params"]
    return jax.device_get(params)


def _encoders(params, fused, fast):
    flags = dict(fused_mlp=fused, fused_attn=fused)
    jax_enc = JaxBioMedCLIPEncoder(
        config=JaxBioMedCLIPConfig(vision=JaxViTConfig(**TINY, **flags),
                                   text=None, projection_dim=PROJ),
        params={"image": params}, device="cpu", fast=fast)
    port_enc = BioMedCLIPEncoder(
        config=BioMedCLIPConfig(vision=ViTConfig(**TINY, **flags),
                                projection_dim=PROJ),
        params=params_from_jax({"image": params}), device="cpu", fast=fast)
    return jax_enc, port_enc


def _run(module, encoder, manifest, out_dir):
    paths = module.load_images(manifest, out_dir)
    embeddings = module.encode_images(encoder, paths, batch_size=4)
    module.save_embeddings(embeddings, out_dir)
    return embeddings


def test_step2_fused_tower_matches_jax(cohort, jax_image_params, tmp_path):
    """f32 towers on the fused path: the algorithm, checked tightly."""
    root, manifest = cohort
    jax_enc, port_enc = _encoders(jax_image_params, fused=True, fast=False)
    want = _run(jax_step2, jax_enc, manifest, tmp_path / "jax")
    got = _run(step2, port_enc, manifest, tmp_path / "port")
    assert list(got) == list(want) == ["P000", "P001", "P002"]
    for pid in want:
        assert got[pid].shape == want[pid].shape == (5, PROJ)
        assert got[pid].dtype == np.float32
        np.testing.assert_allclose(got[pid], want[pid], atol=1e-4)
    meta = [json.loads((tmp_path / d / "embeddings_meta.json").read_text())
            for d in ("jax", "port")]
    assert meta[0] == meta[1] == {"num_patients": 3,
                                  "patients": ["P000", "P001", "P002"],
                                  "embedding_dim": PROJ}
    npz = np.load(tmp_path / "port" / "embeddings.npz")
    np.testing.assert_array_equal(npz["P001"], got["P001"])


def test_step2_fast_bf16_matches_jax(cohort, jax_image_params, tmp_path):
    """``fast=True`` on both sides: bf16 weights and activations on the
    fused path. The JAX package returns bf16 rows normalised in bf16, the
    port f32 rows normalised in f32, so the bound is bf16's."""
    root, manifest = cohort
    jax_enc, port_enc = _encoders(jax_image_params, fused=False, fast=True)
    paths = step2.load_images(manifest, root)
    want = jax_step2.encode_images(jax_enc, paths, batch_size=4)
    got = step2.encode_images(port_enc, paths, batch_size=4)
    for pid in want:
        w = np.asarray(want[pid], np.float32)
        assert got[pid].shape == w.shape
        np.testing.assert_allclose(got[pid], w, atol=2e-2)
        cos = (got[pid] * w).sum(-1) / np.linalg.norm(w, axis=-1)
        assert cos.min() > 0.999, cos


def test_step2_fast_routes_through_fused_ops(jax_image_params):
    _, port_enc = _encoders(jax_image_params, fused=False, fast=True)
    trunk = port_enc.image_model.trunk
    assert trunk.config.dtype == torch.bfloat16
    assert all(b.fused_attn and b.fused_mlp for b in trunk.blocks)
    assert {p.dtype for p in port_enc.image_model.parameters()} == {torch.bfloat16}


def test_fast_int8_and_text_raise(jax_image_params):
    """An image-only encoder (no text tree) builds with fast="int8" but
    has no text side; a text tower without a tokenizer raises as JAX's
    does; a mesh that is not the port's ``Mesh`` is refused with a clear
    error, and a one-device CPU mesh encodes as no mesh does."""
    image_only = params_from_jax({"image": jax_image_params})
    cfg = BioMedCLIPConfig(vision=ViTConfig(**TINY), projection_dim=PROJ)
    int8 = BioMedCLIPEncoder(config=cfg, params=image_only, device="cpu",
                             fast="int8")
    assert int8.text_model is None
    with pytest.raises(NotImplementedError, match="text-less"):
        int8.encode_batch_texts(["fever, cough"])
    from emr2a_tpu_torch.models.text import BertConfig
    tiny_bert = dict(vocab_size=40, max_length=16, hidden_size=64,
                     num_layers=1, num_heads=2, mlp_dim=128)
    no_tok = BioMedCLIPEncoder.random_init(
        BioMedCLIPConfig(vision=ViTConfig(**TINY), text=BertConfig(**tiny_bert),
                         projection_dim=PROJ), device="cpu", fast="int8")
    with pytest.raises(NotImplementedError, match="no tokenizer"):
        no_tok.encode_batch_texts(["fever, cough"])
    with pytest.raises(TypeError, match="mesh must be an emr2a_tpu_torch.parallel.Mesh"):
        BioMedCLIPEncoder(config=cfg, params=image_only, device="cpu",
                          mesh=object())
    from emr2a_tpu_torch.parallel import create_mesh
    on_mesh = BioMedCLIPEncoder(config=cfg, params=image_only, fast="int8",
                                mesh=create_mesh((1, 1), devices=["cpu"]))
    img = np.random.RandomState(0).randint(0, 256, (224, 224, 3), dtype=np.uint8)
    np.testing.assert_array_equal(on_mesh.encode_image(img), int8.encode_image(img))


def test_step2_cli_fake_encoder_matches_jax(tmp_path):
    # the fake encoder hashes bytes(image.shape), so its images keep every
    # side below 256 (both packages raise on larger ones)
    from PIL import Image
    rng = np.random.RandomState(5)
    records = []
    for p in range(3):
        slices = []
        for s, (h, w) in enumerate([(24, 24), (32, 40), (24, 24)]):
            path = tmp_path / f"p{p}_s{s}.png"
            Image.fromarray((rng.rand(h, w, 3) * 255).astype(np.uint8)).save(path)
            slices.append(str(path))
        records.append({"patient_id": f"P{p:03d}", "slices": slices})
    manifest = str(tmp_path / "manifest.jsonl")
    (tmp_path / "manifest.jsonl").write_text(
        "".join(json.dumps(r) + "\n" for r in records), encoding="utf-8")
    jax_step2.main(["--manifest_path", manifest, "--encoder_type", "fake",
                    "--device", "cpu", "--output_dir", str(tmp_path / "jax")])
    step2.main(["--manifest_path", manifest, "--encoder_type", "fake",
                "--device", "cpu", "--output_dir", str(tmp_path / "port")])
    want = np.load(tmp_path / "jax" / "embeddings.npz")
    got = np.load(tmp_path / "port" / "embeddings.npz")
    assert got.files == want.files == ["P000", "P001", "P002"]
    for pid in want.files:
        assert got[pid].dtype == want[pid].dtype
        np.testing.assert_array_equal(got[pid], want[pid])
    assert ((tmp_path / "port" / "embeddings_meta.json").read_bytes()
            == (tmp_path / "jax" / "embeddings_meta.json").read_bytes())


def test_step2_cli_rejects_unported_choices(cohort, tmp_path, monkeypatch):
    """Every encoder type is ported: the CLI raises where JAX's raises, with
    JAX's exception and message (``clip`` without a checkpoint, a Qwen type
    with ``--fast``), and the default ``vit`` (a random tower, here at a
    small width in both packages) writes the cohort's artifacts.
    ``--data_parallel`` runs: the fake encoder ignores it, as JAX's does, and
    the vit run over the one-device CPU mesh writes the rows it writes
    without the flag."""
    import dataclasses

    import emr2a_tpu.encoders.vit_encoder as jax_vit
    import emr2a_tpu_torch.encoders.vit_encoder as port_vit
    root, _ = cohort
    args = ["--manifest_path", str(root / "manifest.jsonl"), "--device", "cpu"]
    for extra in (["--encoder_type", "clip"], ["--encoder_type", "qwen3_vl", "--fast"],
                  ["--encoder_type", "qwen3_vl_2b"]):
        errors = []
        for module in (jax_step2, step2):
            with pytest.raises(ValueError) as e:
                module.main(args + ["--output_dir", str(tmp_path / "x")] + extra)
            errors.append(str(e.value))
        assert errors[0] == errors[1], extra
    for name, module in (("jax_fake", jax_step2), ("port_fake", step2)):
        module.main(args + ["--output_dir", str(tmp_path / name), "--encoder_type",
                            "fake", "--data_parallel"])
    want, got = (np.load(tmp_path / n / "embeddings.npz") for n in ("jax_fake", "port_fake"))
    assert got.files == want.files and all(np.array_equal(got[p], want[p]) for p in want.files)
    for mod in (jax_vit, port_vit):
        monkeypatch.setattr(mod, "TIMM_VIT_B16", dataclasses.replace(
            mod.TIMM_VIT_B16, patch_size=32, hidden_size=64, num_layers=1,
            num_heads=2, mlp_dim=128))
    step2.main(args + ["--output_dir", str(tmp_path / "vit")])      # the default type
    npz = np.load(tmp_path / "vit" / "embeddings.npz")
    assert npz.files == ["P000", "P001", "P002"]
    assert all(npz[p].shape == (5, 64) and np.isfinite(npz[p]).all() for p in npz.files)
    step2.main(args + ["--output_dir", str(tmp_path / "vit_dp"), "--data_parallel"])
    dp = np.load(tmp_path / "vit_dp" / "embeddings.npz")
    assert dp.files == npz.files and all(np.array_equal(dp[p], npz[p]) for p in npz.files)
