"""The port's similarity and fusion primitives against
``emr2a_tpu.ops.similarity`` / ``emr2a_tpu.ops.fusion`` on the same
inputs (f32; values within 1e-6 absolute, from sums taken in another
order), including the zero-vector guards."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emr2a_tpu.ops import fusion as jax_fusion
from emr2a_tpu.ops import similarity as jax_sim
from emr2a_tpu_torch.ops import fusion as port_fusion
from emr2a_tpu_torch.ops import similarity as port_sim

torch.set_num_threads(1)


def _close(got, want, atol=1e-6):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=atol)


@pytest.mark.parametrize("zero", [False, True])
def test_single_vector_normalisation_and_similarities(rng, zero):
    q = np.zeros(16, np.float32) if zero else rng.randn(16).astype(np.float32)
    db = rng.randn(30, 16).astype(np.float32)
    db[4] = q
    t = torch.from_numpy
    _close(port_sim.l2_normalize(t(q)), jax_sim.l2_normalize(jnp.asarray(q)))
    _close(port_sim.cosine_similarity(t(q), t(db)),
           jax_sim.cosine_similarity(jnp.asarray(q), jnp.asarray(db)))
    _close(port_sim.euclidean_similarity(t(q), t(db)),
           jax_sim.euclidean_similarity(jnp.asarray(q), jnp.asarray(db)), atol=1e-5)
    same = np.repeat(q[None], 3, axis=0)          # every distance 0
    _close(port_sim.euclidean_similarity(t(q), t(same)),
           jax_sim.euclidean_similarity(jnp.asarray(q), jnp.asarray(same)))


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cosine_similarity_matrix(rng, normalize, dtype):
    q = rng.randn(5, 24).astype(np.float32)
    db = rng.randn(40, 24).astype(np.float32)
    got = port_sim.cosine_similarity_matrix(
        torch.from_numpy(q).to(getattr(torch, dtype)),
        torch.from_numpy(db).to(getattr(torch, dtype)), normalize=normalize)
    want = jax_sim.cosine_similarity_matrix(
        jnp.asarray(q, getattr(jnp, dtype)), jnp.asarray(db, getattr(jnp, dtype)),
        normalize=normalize)
    assert got.dtype == torch.float32
    # bf16 rows normalised in bf16 by both: a rounding apart
    _close(got, want, atol=2e-2 if dtype == "bfloat16" and normalize else 1e-5)


@pytest.mark.parametrize("mode", ["none", "zscore", "minmax"])
def test_score_normalisation_and_late_fusion(rng, mode):
    text = rng.randn(4, 50).astype(np.float32)
    image = rng.randn(4, 50).astype(np.float32) * 3
    _close(port_fusion.normalize_scores(torch.from_numpy(text), mode),
           jax_fusion.normalize_scores(jnp.asarray(text), mode), atol=1e-5)
    _close(port_fusion.late_fusion(torch.from_numpy(text), torch.from_numpy(image),
                                   0.3, mode),
           jax_fusion.late_fusion(jnp.asarray(text), jnp.asarray(image), 0.3, mode),
           atol=1e-5)


def test_early_and_concat_fusion(rng):
    text = rng.randn(6, 8).astype(np.float32)
    image = rng.randn(6, 12).astype(np.float32)
    t = torch.from_numpy
    _close(port_fusion.early_fusion(t(text), t(image), 0.5, 2.0),
           jax_fusion.early_fusion(jnp.asarray(text), jnp.asarray(image), 0.5, 2.0))
    _close(port_fusion.concat_fusion_rows(t(image), t(text)),
           jax_fusion.concat_fusion_rows(jnp.asarray(image), jnp.asarray(text)))
    for tv in (text[0], np.zeros(8, np.float32)):
        iv = image[0] if tv.any() else np.zeros(12, np.float32)
        _close(port_fusion.concat_embeddings(t(tv), t(iv), 2.0, 1.0),
               jax_fusion.concat_embeddings(jnp.asarray(tv), jnp.asarray(iv), 2.0, 1.0))
