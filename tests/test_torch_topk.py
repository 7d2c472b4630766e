"""Port ``cosine_topk`` / ``topk_scores`` against ``emr2a_tpu.ops.topk``,
with exact ties, which must go to the lowest index as in
``jax.lax.top_k``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emr2a_tpu.ops import topk as jax_topk
from emr2a_tpu_torch.ops import topk as port_topk

torch.set_num_threads(1)


@pytest.mark.parametrize("normalize", [True, False])
def test_cosine_topk_matches_jax_with_ties(rng, normalize):
    db = rng.randn(40, 16).astype(np.float32)
    db[[7, 21, 33]] = db[3]            # four identical rows
    db[[12, 30]] = db[5] * 2.0         # same direction, other norm
    queries = np.concatenate([db[[3, 5]], rng.randn(3, 16)]).astype(np.float32)
    want_v, want_i = jax_topk.cosine_topk(jnp.asarray(queries), jnp.asarray(db),
                                          k=6, normalize=normalize)
    got_v, got_i = port_topk.cosine_topk(torch.from_numpy(queries),
                                         torch.from_numpy(db), k=6,
                                         normalize=normalize)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), atol=1e-6)


def test_topk_scores_ties_go_to_lowest_index():
    scores = np.array([[1.0, 3.0, 3.0, 2.0, 3.0, 0.0],
                       [5.0, 5.0, 5.0, 5.0, 5.0, 5.0]], np.float32)
    want_v, want_i = jax_topk.topk_scores(jnp.asarray(scores), 4)
    got_v, got_i = port_topk.topk_scores(torch.from_numpy(scores), 4)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_i.numpy(), [[1, 2, 4, 3], [0, 1, 2, 3]])
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


# -- K6: the fused scan's plain version, against the Pallas kernel ---------

def _unit(x):
    return (x / (np.linalg.norm(x, axis=1, keepdims=True) + 1e-8)).astype(np.float32)


@pytest.mark.parametrize("n,dim,q,k,tile,dtype", [
    (100, 64, 4, 5, 32, "float32"),      # tail-padded DB
    (256, 128, 8, 3, 128, "float32"),    # exact tiles
    (513, 40, 2, 10, 256, "float32"),    # odd everything
    (300, 96, 5, 7, 128, "bfloat16"),    # bf16 storage, queries cast to it
])
def test_cosine_topk_fused_matches_pallas_interpret(rng, n, dim, q, k, tile, dtype):
    """Indices exact; values within rtol 1e-4, atol 1e-5 (f32 sums in
    another order)."""
    qs = _unit(rng.randn(q, dim))
    db = _unit(rng.randn(n, dim))
    want_v, want_i = jax_topk.cosine_topk_pallas(
        jnp.asarray(qs), jnp.asarray(db, dtype=getattr(jnp, dtype)), k,
        tile=tile, interpret=True)
    got_v, got_i = port_topk.cosine_topk_fused(
        torch.from_numpy(qs), torch.from_numpy(db).to(getattr(torch, dtype)), k)
    assert got_i.dtype == torch.int32 and got_v.dtype == torch.float32
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v),
                               rtol=1e-4, atol=1e-5)


def test_cosine_topk_fused_masks_rows_past_n_valid(rng):
    """n_valid < n: equal to the Pallas kernel over the first n_valid rows
    (exact indices, values within 1e-5); a masked row never surfaces."""
    qs = _unit(rng.randn(3, 32))
    db = _unit(rng.randn(90, 32))
    db[70:] = qs[0]                    # the best rows, all masked
    want_v, want_i = jax_topk.cosine_topk_pallas(
        jnp.asarray(qs), jnp.asarray(db[:70]), 6, tile=32, interpret=True)
    got_v, got_i = port_topk.cosine_topk_fused(
        torch.from_numpy(qs), torch.from_numpy(db), 6, n_valid=70)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), atol=1e-5)
    assert got_i.max().item() < 70


@pytest.mark.parametrize("int8", [False, True])
def test_cosine_topk_fused_ties_go_to_the_lowest_index(rng, int8):
    db = _unit(rng.randn(64, 16))
    db[[9, 30, 31, 63]] = db[2]        # five equal rows
    q = torch.from_numpy(db[[2]])
    if int8:
        from emr2a_tpu_torch.retrieval.database import quantize_rows_int8
        codes, scales = quantize_rows_int8(db)
        v, i = port_topk.cosine_topk_fused_int8(
            q, torch.from_numpy(codes), torch.from_numpy(scales), 6)
    else:
        v, i = port_topk.cosine_topk_fused(q, torch.from_numpy(db), 6)
    assert i[0, :5].tolist() == [2, 9, 30, 31, 63]
    assert (v[0, :5] == v[0, 0]).all() and v[0, 5] < v[0, 0]


def test_cosine_topk_fused_int8_matches_the_jax_int8_db(rng):
    """The int8 plain version against JAX's int8 scan through its
    database (XLA): indices identical, values within 1e-6."""
    from emr2a_tpu.retrieval.database import (
        ShardedEmbeddingDatabase as JaxDB,
        quantize_rows_int8,
    )
    emb = _unit(rng.randn(300, 48))
    queries = _unit(emb[:12] + 0.1 * rng.randn(12, 48))
    queries[3] = 0.0                   # a zero query: scale 1, codes 0
    jdb = JaxDB(emb, dtype=jnp.int8, normalize=False)
    want_v, want_i = jdb.topk(queries, 7, normalize=False)
    codes, scales = quantize_rows_int8(emb)
    got_v, got_i = port_topk.cosine_topk_fused_int8(
        torch.from_numpy(queries), torch.from_numpy(codes),
        torch.from_numpy(scales), 7)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=0, atol=1e-6)


def test_cosine_topk_fused_k_limits(rng):
    """Any 1 <= k <= n_valid, as the JAX scans take any k: k = 65 and 100
    (past the streaming scan's lists) equal JAX's Pallas kernel in interpret
    mode (indices exact, values within 1e-5); k = 0 and k > n_valid raise."""
    db = _unit(rng.randn(300, 16))
    q = db[:2] + 0.01
    for k in (65, 100):
        want_v, want_i = jax_topk.cosine_topk_pallas(
            jnp.asarray(q), jnp.asarray(db), k, tile=128, interpret=True)
        got_v, got_i = port_topk.cosine_topk_fused(torch.from_numpy(q),
                                                   torch.from_numpy(db), k)
        assert got_v.shape == (2, k) and got_i[:, 0].tolist() == [0, 1]
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=1e-4, atol=1e-5)
    dbt = torch.from_numpy(db)
    with pytest.raises(ValueError, match="k must be"):
        port_topk.cosine_topk_fused(dbt[:2], dbt, 0)
    with pytest.raises(ValueError, match="valid rows"):
        port_topk.cosine_topk_fused(dbt[:2], dbt, 11, n_valid=10)
    with pytest.raises(ValueError, match="valid rows"):
        port_topk.cosine_topk_fused(dbt[:2], dbt[:70], 71)


@pytest.mark.parametrize("k,dtype", [(65, "bfloat16"), (100, "float32"), (100, "bfloat16")])
def test_cosine_topk_fused_large_k_matches_pallas_interpret(rng, k, dtype):
    """k past the streaming scan's 64 on a tail-padded DB with n_valid < n:
    equal to the Pallas kernel over the first n_valid rows (indices exact,
    values within rtol 1e-4, atol 1e-5)."""
    qs = _unit(rng.randn(5, 40))
    db = _unit(rng.randn(340, 40))
    db[300:] = qs[0]                   # the best rows, all masked
    want_v, want_i = jax_topk.cosine_topk_pallas(
        jnp.asarray(qs), jnp.asarray(db[:300], dtype=getattr(jnp, dtype)), k,
        tile=128, interpret=True)
    got_v, got_i = port_topk.cosine_topk_fused(
        torch.from_numpy(qs), torch.from_numpy(db).to(getattr(torch, dtype)), k, n_valid=300)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("k", [65, 100])
def test_cosine_topk_fused_int8_large_k_matches_the_jax_int8_db(rng, k):
    """The int8 variant at k past 64 against JAX's int8 database scan:
    indices identical, values within 1e-6."""
    from emr2a_tpu.retrieval.database import (
        ShardedEmbeddingDatabase as JaxDB,
        quantize_rows_int8,
    )
    emb = _unit(rng.randn(300, 48))
    queries = _unit(emb[:6] + 0.1 * rng.randn(6, 48))
    jdb = JaxDB(emb, dtype=jnp.int8, normalize=False)
    want_v, want_i = jdb.topk(queries, k, normalize=False)
    codes, scales = quantize_rows_int8(emb)
    got_v, got_i = port_topk.cosine_topk_fused_int8(
        torch.from_numpy(queries), torch.from_numpy(codes), torch.from_numpy(scales), k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=0, atol=1e-6)
