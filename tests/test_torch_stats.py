"""The port's StandardScaler / PCA / fold whitening against
``emr2a_tpu.ops.stats`` and sklearn on the same inputs.

Tolerances: rtol 1e-4 / atol 1e-5 for the scaler, rtol 1e-3 / atol 1e-4
after PCA (an f32 SVD in JAX against f64 here and in sklearn), the same
bars as ``tests/test_ops_stats.py``. Signs must agree: both packages fix
them with sklearn's ``svd_flip(u_based_decision=False)``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.decomposition import PCA as SkPCA
from sklearn.preprocessing import StandardScaler as SkScaler

from emr2a_tpu.ops import stats as jax_stats
from emr2a_tpu_torch.ops import stats as port_stats

torch.set_num_threads(1)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("constant_feature", [False, True])
def test_scaler_matches_sklearn_and_jax(rng, constant_feature):
    x = rng.randn(40, 12) * 3 + 1
    if constant_feature:
        x[:, 2] = 5.0                   # std 0 -> scale 1
    y = rng.randn(10, 12)
    sk = SkScaler().fit(x)
    ours = port_stats.StandardScaler().fit(x)
    theirs = jax_stats.StandardScaler().fit(x)
    np.testing.assert_allclose(_np(ours.transform(y)), sk.transform(y), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(_np(ours.transform(y)), _np(theirs.transform(y)),
                               rtol=1e-4, atol=1e-5)
    if constant_feature:
        assert ours.state.scale[2].item() == 1.0


def test_scaler_near_constant_feature_scales_by_one():
    """std below 10 * eps of the dtype counts as constant (sklearn's
    _handle_zeros_in_scale), in f32 as in JAX."""
    x = np.ones((6, 2), np.float32)
    x[:, 1] += np.float32(1e-7) * np.arange(6)
    got = port_stats.scaler_fit(torch.from_numpy(x)).scale
    want = jax_stats.scaler_fit(jnp.asarray(x)).scale
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[1].item() == 1.0


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_pca_matches_sklearn_and_jax_including_sign(rng, dtype):
    x = rng.randn(50, 16).astype(dtype)
    y = rng.randn(12, 16).astype(dtype)
    sk = SkPCA(n_components=6).fit(x)
    ours = port_stats.PCA(n_components=6).fit(x)
    theirs = jax_stats.PCA(n_components=6).fit(x)
    got = _np(ours.transform(y))
    np.testing.assert_allclose(got, sk.transform(y), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(got, _np(theirs.transform(y)), rtol=1e-3, atol=1e-4)
    comps = ours.state.components
    assert comps.shape == (6, 16)
    # svd_flip(u_based_decision=False): the largest |.| of each row is positive
    rows = torch.arange(6)
    assert (comps[rows, comps.abs().argmax(dim=1)] > 0).all()


def test_pca_raises_bf16_to_f32(rng):
    x = torch.from_numpy(rng.randn(30, 8).astype(np.float32)).bfloat16()
    state = port_stats.pca_fit(x, 3)
    assert state.components.dtype == torch.float32


def _sk_whiten(train, test, n_components):
    sc = SkScaler()
    tr, te = sc.fit_transform(train), sc.transform(test)
    if n_components:
        pca = SkPCA(n_components=n_components)
        tr, te = pca.fit_transform(tr), pca.transform(te)
    tr = tr / (np.linalg.norm(tr, axis=1, keepdims=True) + 1e-8)
    te = te / (np.linalg.norm(te, axis=1, keepdims=True) + 1e-8)
    return tr, te


@pytest.mark.parametrize("pca_dim", [0, 10])
def test_whitening_matches_sklearn_and_jax(rng, pca_dim):
    train = rng.randn(30, 20)
    test = rng.randn(8, 20)
    if pca_dim:
        got = port_stats.fit_whiten_transform(torch.from_numpy(train),
                                              torch.from_numpy(test), pca_dim)
        jax_out = jax_stats.fit_whiten_transform(train, test, pca_dim)
    else:
        got = port_stats.whiten_no_pca(torch.from_numpy(train), torch.from_numpy(test))
        jax_out = jax_stats.whiten_no_pca(train, test)
    for g, s, j in zip(got, _sk_whiten(train, test, pca_dim), jax_out):
        np.testing.assert_allclose(g.numpy(), s, rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=1e-3, atol=1e-4)
