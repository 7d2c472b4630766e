"""``encode_images`` on paths through the decode pool, port against JAX:
the DINOv3 encoder (an exact-resize spec: both packages resize with the
pool's box filter), BioMedCLIP with ``assume_square_sources`` (its
shortest-edge spec then takes the pool too), and a run over several chunks
with failed files and a chunk that fails whole, which must give JAX's rows
in JAX's order. Slices come from ``tools/cohort.write_cohort`` (512x512 grey
PNGs); the towers are narrow.

Tolerances: the DINO tests' f32 ones (atol 3e-4, rtol 1e-3); the step2
tests' for BioMedCLIP (atol 1e-4 in f32, row cosine 0.999 with ``fast``).
"""

import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from emr2a_tpu_torch.data import native_loader
from emr2a_tpu_torch.models.convert import params_from_jax

sys.path.insert(0, str(Path(__file__).resolve().parent / "helpers"))
from jax_pool_gate import jax_pool_available  # noqa: E402

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(not jax_pool_available(),
                                reason="the JAX package's decode pool cannot build here")

DINO = dict(hidden_size=64, num_layers=1, num_heads=2, mlp_dim=128)
BIOMEDCLIP = dict(image_size=224, patch_size=32, hidden_size=64, num_layers=2,
                  num_heads=2, mlp_dim=128, ln_eps=1e-6, pooling="cls")


@pytest.fixture(scope="module")
def slices(tmp_path_factory):
    import json

    from emr2a_tpu_torch.tools.cohort import write_cohort
    root = tmp_path_factory.mktemp("cohort")
    manifest = write_cohort(root, n_patients=2, n_slices=3)
    return [p for line in manifest.read_text().splitlines()
            for p in json.loads(line)["slices"]]


@pytest.fixture(scope="module")
def dino_pair():
    from emr2a_tpu.encoders.dino_encoder import DINOEncoder as JaxDINO
    from emr2a_tpu.models.dinov3 import DINOv3Config as JaxConfig
    from emr2a_tpu_torch.encoders.dino_encoder import DINOEncoder
    from emr2a_tpu_torch.models.dinov3 import DINOv3Config
    jax_enc = JaxDINO(config=JaxConfig(**DINO), device="cpu")
    port = DINOEncoder(config=DINOv3Config(**DINO), device="cpu",
                       params=params_from_jax(jax.device_get(jax_enc.params)))
    return jax_enc, port


def test_dino_encode_images_matches_jax(dino_pair, slices):
    """JAX's step2 resizes DINOv3 inputs with the pool's integer box filter;
    the port does too (before the pool it used cv2's INTER_AREA, which
    differs on most pixels)."""
    jax_enc, port = dino_pair
    before = native_loader.POOL_BATCHES
    got = port.encode_images(slices)
    want = np.asarray(jax_enc.encode_images(slices), np.float32)
    assert native_loader.POOL_BATCHES == before + 1
    assert got.shape == want.shape == (len(slices), 64) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=3e-4, rtol=1e-3)


def test_chunks_with_failures_match_jax(dino_pair, slices, tmp_path):
    """max_batch 2 over seven paths: a failed row in the first chunk, a
    second chunk of failures only (skipped), a full chunk and a chunk of
    one; rows come back in JAX's order, failures dropped."""
    jax_enc, port = dino_pair
    bad = tmp_path / "bad.png"
    bad.write_text("not an image")
    paths = [slices[0], tmp_path / "missing.png", bad, tmp_path / "gone.png",
             slices[1], slices[2], slices[3]]
    jax_enc.max_batch = port.max_batch = 2
    try:
        before = native_loader.POOL_BATCHES
        got = port.encode_images(paths)
        want = np.asarray(jax_enc.encode_images(paths), np.float32)
    finally:
        jax_enc.max_batch = port.max_batch = 128
    assert native_loader.POOL_BATCHES == before + 4
    assert got.shape == want.shape == (4, 64)
    np.testing.assert_allclose(got, want, atol=3e-4, rtol=1e-3)
    np.testing.assert_allclose(got, port.encode_images([slices[i] for i in (0, 1, 2, 3)]),
                               atol=1e-6)
    empty = port.encode_images([bad, tmp_path / "missing.png"])
    assert empty.shape == (0,)


def test_no_compiler_falls_back_to_host_decode(dino_pair, slices, monkeypatch):
    """Without a pool the port decodes per image (cv2 / PIL), as JAX does
    when its pool cannot build: same rows, near but not equal values."""
    _, port = dino_pair
    monkeypatch.setattr("emr2a_tpu_torch.encoders.jit_encoder.native_available", lambda: False)
    before = native_loader.POOL_BATCHES
    host = port.encode_images(slices[:2])
    assert native_loader.POOL_BATCHES == before and host.shape == (2, 64)
    monkeypatch.undo()
    pooled = port.encode_images(slices[:2])
    cos = (host * pooled).sum(-1)
    assert cos.min() > 0.99


@pytest.mark.parametrize("fused,fast", [(False, False), (True, False), (True, True)])
def test_biomedclip_square_sources_matches_jax(slices, fused, fast):
    """With ``assume_square_sources`` both packages' BioMedCLIP take the pool
    at 224x224 for their shortest-edge spec; without it neither does."""
    from emr2a_tpu.encoders.biomedclip_encoder import BioMedCLIPEncoder as JaxBioMedCLIP
    from emr2a_tpu.models.clip import BioMedCLIPConfig as JaxCLIPConfig
    from emr2a_tpu.models.clip import BioMedCLIPImageTower as JaxTower
    from emr2a_tpu.models.vit import ViTConfig as JaxViTConfig
    from emr2a_tpu_torch.encoders.biomedclip_encoder import BioMedCLIPEncoder
    from emr2a_tpu_torch.models.clip import BioMedCLIPConfig
    from emr2a_tpu_torch.models.vit import ViTConfig
    flags = dict(fused_mlp=fused, fused_attn=fused)
    jcfg = JaxCLIPConfig(vision=JaxViTConfig(**BIOMEDCLIP, **flags), text=None, projection_dim=32)
    params = jax.device_get(JaxTower(jcfg).init(
        jax.random.PRNGKey(0), np.zeros((1, 224, 224, 3), np.float32))["params"])
    jax_enc = JaxBioMedCLIP(config=jcfg, params={"image": params}, device="cpu", fast=fast)
    port = BioMedCLIPEncoder(
        config=BioMedCLIPConfig(vision=ViTConfig(**BIOMEDCLIP, **flags), projection_dim=32),
        params=params_from_jax({"image": params}), device="cpu", fast=fast)
    assert port.assume_square_sources is False
    before = native_loader.POOL_BATCHES
    port.encode_images(slices[:1])
    assert native_loader.POOL_BATCHES == before
    jax_enc.assume_square_sources = port.assume_square_sources = True
    got = port.encode_images(slices)
    want = np.asarray(jax_enc.encode_images(slices), np.float32)
    assert native_loader.POOL_BATCHES == before + 1
    assert got.shape == want.shape == (len(slices), 32)
    if fast:
        cos = (got * want).sum(-1) / np.linalg.norm(want, axis=-1)
        assert cos.min() >= 0.999, cos
    else:
        np.testing.assert_allclose(got, want, atol=1e-4)


def test_flag_is_an_attribute_not_forwarded():
    """As in JAX, the engine takes ``assume_square_sources`` and the
    encoders built on it leave it False for a caller to set."""
    from emr2a_tpu_torch.encoders.dino_encoder import DINOEncoder
    from emr2a_tpu_torch.encoders.jit_encoder import BatchedImageTextEncoder
    from emr2a_tpu_torch.models.dinov3 import DINOv3Config
    enc = DINOEncoder(config=DINOv3Config(**DINO), device="cpu")
    assert enc.assume_square_sources is False
    engine = BatchedImageTextEncoder(torch.nn.Identity(), device="cpu",
                                     assume_square_sources=True)
    assert engine.assume_square_sources is True


def test_step2_e2e_tool(tmp_path):
    """``tools/step2_e2e``: the CLI on the CPU (full-width BioMedCLIP, two
    slices, with texts) reports its rates; ``measure`` with and without
    the pool encodes every slice, counts the pool's batches only with it,
    leaves the encoder's flag as it was, and the two runs' rows agree."""
    from emr2a_tpu_torch.encoders.biomedclip_encoder import BioMedCLIPEncoder
    from emr2a_tpu_torch.models.clip import BioMedCLIPConfig
    from emr2a_tpu_torch.models.vit import ViTConfig
    from emr2a_tpu_torch.tools import step2_e2e

    res = step2_e2e.main(["--device", "cpu", "--patients", "1", "--slices", "2",
                          "--batch_size", "2", "--precision", "bf16", "--text",
                          "--keep", str(tmp_path / "cohort")])
    assert res["encoded"] == res["slices"] == 2 and res["pool"] and res["pool_batches"] == 1
    assert res["texts"] == 1 and res["end_to_end_slices_per_s"] > 0
    assert (tmp_path / "cohort" / "out" / "embeddings.npz").exists()

    enc = BioMedCLIPEncoder.random_init(
        config=BioMedCLIPConfig(vision=ViTConfig(**BIOMEDCLIP), projection_dim=32),
        device="cpu", max_batch=2)
    paths = {"P000": [tmp_path / "cohort" / "CT_2D_image_core" / "Bacterial" / "patient_00"
                      / f"slice_{s}.png" for s in range(2)]}
    rows = {}
    for pool in (True, False):
        r = step2_e2e.measure(enc, paths, tmp_path / str(pool), 2, pool=pool)
        assert r["encoded"] == 2 and r["pool_batches"] == (1 if pool else 0)
        assert enc.assume_square_sources is False
        rows[pool] = np.load(tmp_path / str(pool) / "embeddings.npz")["P000"]
    assert ((rows[True] * rows[False]).sum(-1) > 0.99).all()
