"""Data-parallel encoding over a CPU mesh: the port's BioMedCLIP encoder
with ``mesh=`` against the JAX package's with ``mesh=`` (its ``shard_map``
over the 8 CPU devices of tests/conftest.py), on the same params carried
across by ``params_from_jax``, mirroring tests/test_encoders.py's data-
parallel image and text tests (a mask, a data axis of 8 and of 6) and
tests/test_quantized_tower.py's int8 one; and the port on a mesh against
the port without one, bit for bit.

Tolerances against JAX, those of tests/test_torch_step2*.py on the same
paths: f32 rows within 1e-4 of JAX's (sums in another order); ``fast=True``
(bf16) and ``fast="int8"`` row cosine >= 0.999, since JAX returns bf16 rows
normalised in bf16 and the port f32 rows. Against the port without a mesh:
the bf16 and the int8 towers (the main path's) bit for bit, since a row's
features do not depend on the rows beside it; the f32 tower within 5e-7,
since the CPU's f32 matrix product sums in an order that follows the
product's row count (a shard's 2 rows against 12), a few f32 ulps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from emr2a_tpu.encoders.biomedclip_encoder import BioMedCLIPEncoder as JaxEncoder
from emr2a_tpu.models.clip import BioMedCLIPConfig as JaxBioMedCLIPConfig
from emr2a_tpu.models.clip import BioMedCLIPImageTower as JaxImageTower
from emr2a_tpu.models.clip import BioMedCLIPTextTower as JaxTextTower
from emr2a_tpu.models.text import BertConfig as JaxBertConfig
from emr2a_tpu.models.vit import ViTConfig as JaxViTConfig
from emr2a_tpu.pipelines.step2_embeddings import build_embeddings as jax_step2
from emr2a_tpu_torch.encoders.biomedclip_encoder import BioMedCLIPEncoder
from emr2a_tpu_torch.models.clip import BioMedCLIPConfig
from emr2a_tpu_torch.models.convert import params_from_jax
from emr2a_tpu_torch.models.text import BertConfig
from emr2a_tpu_torch.models.vit import ViTConfig
from emr2a_tpu_torch.parallel import create_mesh
from emr2a_tpu_torch.pipelines.step2_embeddings import build_embeddings as step2

torch.set_num_threads(1)

VIT = dict(image_size=224, patch_size=32, hidden_size=64, num_layers=2,
           num_heads=2, mlp_dim=128, ln_eps=1e-6, pooling="cls")
BERT = dict(vocab_size=64, max_length=16, hidden_size=64, num_layers=2,
            num_heads=2, mlp_dim=128)
PROJ = 32


class _BertTok:
    """tests/test_encoders.py's stub: [CLS]=2, one id a character, [SEP]=1,
    padding 0 (the mask)."""

    def __call__(self, texts, **kw):
        n = kw.get("max_length", 16)
        ids = np.zeros((len(texts), n), np.int64)
        for i, t in enumerate(texts):
            toks = [2] + [3 + (ord(c) % 60) for c in t[:n - 2]] + [1]
            ids[i, :len(toks)] = toks
        return {"input_ids": ids, "attention_mask": (ids != 0).astype(np.int64)}


@pytest.fixture(scope="module")
def jax_params():
    cfg = JaxBioMedCLIPConfig(vision=JaxViTConfig(**VIT), text=JaxBertConfig(**BERT),
                              projection_dim=PROJ)
    key = jax.random.PRNGKey(0)
    return jax.device_get({
        "image": JaxImageTower(cfg).init(key, jnp.zeros((1, 224, 224, 3)))["params"],
        "text": JaxTextTower(cfg).init(key, jnp.zeros((1, 8), jnp.int32))["params"]})


def _jax_encoder(params, mesh, fast=False):
    return JaxEncoder(config=JaxBioMedCLIPConfig(vision=JaxViTConfig(**VIT),
                                                 text=JaxBertConfig(**BERT),
                                                 projection_dim=PROJ),
                      params=params, tokenizer=_BertTok(), context_length=16,
                      device="cpu", fast=fast, mesh=mesh, max_batch=16)


def _port_encoder(params, mesh, fast=False):
    return BioMedCLIPEncoder(config=BioMedCLIPConfig(vision=ViTConfig(**VIT),
                                                     text=BertConfig(**BERT),
                                                     projection_dim=PROJ),
                             params=params_from_jax(params), tokenizer=_BertTok(),
                             context_length=16, device="cpu", fast=fast, mesh=mesh,
                             max_batch=16)


def _images(n, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.rand(40 + 8 * (i % 3), 40, 3) * 255).astype(np.uint8) for i in range(n)]


def _cosine(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def _assert_matches_jax(got, want, fast):
    got = np.stack(got)
    want = np.stack([np.asarray(w, np.float32) for w in want])
    if fast:
        cos = _cosine(got, want)
        assert cos.min() >= 0.999, cos
    else:
        np.testing.assert_allclose(got, want, atol=1e-4)


def _assert_matches_unsharded(got, single, fast):
    for g, s in zip(got, single):
        if fast:
            np.testing.assert_array_equal(g, s)
        else:
            np.testing.assert_allclose(g, s, rtol=0, atol=5e-7)


@pytest.mark.parametrize("fast", [False, True])
def test_mesh_sharded_image_encoding(jax_params, mesh8, fast):
    """12 images (mixed shapes) over 8 shards: each shape group is padded to
    a multiple of 8 rows, split, and gathered back in order."""
    pmesh = create_mesh((8, 1), devices=["cpu"] * 8)
    sharded = _port_encoder(jax_params, pmesh, fast)
    assert sharded._bucket_for(12) == 16 and sharded._bucket_for(3) == 8
    imgs = _images(12)
    got = sharded.encode_batch_images(imgs)
    assert all(g.shape == (PROJ,) and g.dtype == np.float32 for g in got)
    _assert_matches_jax(got, _jax_encoder(jax_params, mesh8, fast).encode_batch_images(imgs),
                        fast)
    _assert_matches_unsharded(
        got, _port_encoder(jax_params, None, fast).encode_batch_images(imgs), fast)


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("axis", [8, 6])
def test_mesh_sharded_text_with_mask(jax_params, axis, fast):
    """The BERT text path (attention mask present) over a data axis of 8
    and of 6 (7 texts padded to a multiple of the axis)."""
    texts = [f"case {i} ct" for i in range(5)] + ["", "PJP, bilateral ground-glass"]
    jmesh = JaxMesh(np.array(jax.devices()[:axis]).reshape(axis, 1), ("data", "model"))
    pmesh = create_mesh((axis, 1), devices=["cpu"] * axis)
    got = _port_encoder(jax_params, pmesh, fast).encode_batch_texts(texts)
    assert all(np.isfinite(g).all() for g in got)
    _assert_matches_jax(got, _jax_encoder(jax_params, jmesh, fast).encode_batch_texts(texts),
                        fast)
    _assert_matches_unsharded(
        got, _port_encoder(jax_params, None, fast).encode_batch_texts(texts), fast)


def test_quantized_dp_inference(jax_params, mesh8):
    """``fast="int8"`` composes with data parallelism: the W8A8 tower's plain
    versions run per shard; rows within the bf16 bound of JAX's sharded
    int8 rows and bit for bit the unsharded port's."""
    pmesh = create_mesh((8, 1), devices=["cpu"] * 8)
    imgs = _images(16, seed=1)
    got = _port_encoder(jax_params, pmesh, fast="int8").encode_batch_images(imgs)
    want = _jax_encoder(jax_params, mesh8, fast="int8").encode_batch_images(imgs)
    single = _port_encoder(jax_params, None, fast="int8").encode_batch_images(imgs)
    _assert_matches_jax(got, want, "int8")
    _assert_matches_unsharded(got, single, "int8")
    assert all(abs(np.linalg.norm(g) - 1) < 1e-5 for g in got)


def test_step2_encode_images_over_a_mesh(jax_params, mesh8, tmp_path):
    """step2's ``encode_images`` with the bf16 tower (the per-image decode:
    BioMedCLIP's shortest-edge spec, sources not known to be square) with
    the 8-device mesh against JAX's step2 on mesh8 and against the port
    without a mesh; then the decode pool's path (``assume_square_sources``)
    over the mesh against it without one."""
    from PIL import Image
    rng = np.random.RandomState(4)
    paths = {}
    for p in range(2):
        paths[f"P{p:03d}"] = []
        for s in range(5):
            path = tmp_path / f"p{p}_s{s}.png"
            Image.fromarray((rng.rand(64, 64, 3) * 255).astype(np.uint8)).save(path)
            paths[f"P{p:03d}"].append(path)
    pmesh = create_mesh((8, 1), devices=["cpu"] * 8)
    sharded = _port_encoder(jax_params, pmesh, True)
    single = _port_encoder(jax_params, None, True)
    got = step2.encode_images(sharded, paths, batch_size=3)
    want = jax_step2.encode_images(_jax_encoder(jax_params, mesh8, True), paths,
                                   batch_size=3)
    plain = step2.encode_images(single, paths, batch_size=3)
    assert list(got) == list(want) == list(plain) == ["P000", "P001"]
    for pid in got:
        assert got[pid].shape == (5, PROJ)
        _assert_matches_jax(list(got[pid]), list(want[pid]), True)
        np.testing.assert_array_equal(got[pid], plain[pid])
    sharded.assume_square_sources = single.assume_square_sources = True
    pooled = step2.encode_images(sharded, paths, batch_size=3)
    for pid in got:
        np.testing.assert_array_equal(pooled[pid],
                                      step2.encode_images(single, {pid: paths[pid]}, 3)[pid])


def test_data_parallel_flag_on_the_cpu_writes_the_same_npz(tmp_path):
    """``--data_parallel --device cpu`` (a one-device CPU mesh) writes the
    npz and meta the run without the flag writes, on a tiny ViT."""
    import dataclasses
    import json

    from PIL import Image

    import emr2a_tpu_torch.encoders.vit_encoder as port_vit
    rng = np.random.RandomState(6)
    records = []
    for p in range(2):
        slices = []
        for s in range(3):
            path = tmp_path / f"p{p}_s{s}.png"
            Image.fromarray((rng.rand(48, 48, 3) * 255).astype(np.uint8)).save(path)
            slices.append(str(path))
        records.append({"patient_id": f"P{p}", "slices": slices})
    (tmp_path / "m.jsonl").write_text("".join(json.dumps(r) + "\n" for r in records))
    small = dataclasses.replace(port_vit.TIMM_VIT_B16, patch_size=32, hidden_size=64,
                                num_layers=1, num_heads=2, mlp_dim=128)
    saved, port_vit.TIMM_VIT_B16 = port_vit.TIMM_VIT_B16, small
    try:
        for name, extra in (("plain", []), ("dp", ["--data_parallel"])):
            step2.main(["--manifest_path", str(tmp_path / "m.jsonl"), "--device", "cpu",
                        "--output_dir", str(tmp_path / name), "--fast", "int8", *extra])
    finally:
        port_vit.TIMM_VIT_B16 = saved
    a, b = (np.load(tmp_path / n / "embeddings.npz") for n in ("plain", "dp"))
    assert a.files == b.files == ["P0", "P1"]
    assert all(np.array_equal(a[p], b[p]) for p in a.files)
    assert ((tmp_path / "plain" / "embeddings_meta.json").read_bytes()
            == (tmp_path / "dp" / "embeddings_meta.json").read_bytes())
