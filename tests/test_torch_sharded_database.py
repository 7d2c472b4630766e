"""The port's database sharded over an 8-device CPU mesh against JAX's
``ShardedEmbeddingDatabase(mesh=mesh8)`` on the same inputs, mirroring
tests/test_sharded_database.py: n not divisible by 8, n < 8 (empty
shards), k clamped, int8, capacity streaming, geometric growth, save/load
across the two packages, and the CLI's build/add/query on the default mesh.

Tolerances, as tests/test_torch_database.py's: f32 and int8 give JAX's
indices exactly and values within 1e-6 (f32 sums in another order; int8
sums are exact); bf16 normalises the query in bf16 in both packages, where
JAX squares in bf16 and PyTorch in f32, so bf16 is held to the top-1
neighbour and values within 1e-2. Every sharded answer is also held bit for
bit against the port's unsharded database (one CPU device): a row's score
does not depend on the shard that holds it, and the merge keeps the lowest
index on a tie.
"""

import json
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emr2a_tpu.retrieval import database as jax_db
from emr2a_tpu.retrieval import database_cli as jax_cli
from emr2a_tpu_torch.parallel import create_mesh, force_cpu_devices, mesh as port_mesh
from emr2a_tpu_torch.retrieval import database as port_db
from emr2a_tpu_torch.retrieval import database_cli as port_cli

torch.set_num_threads(1)

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16),
          "int8": (jnp.int8, torch.int8)}


@pytest.fixture(scope="module")
def pmesh8():
    return create_mesh((8, 1), devices=["cpu"] * 8)


@pytest.fixture()
def cpu_default_mesh():
    """The port's default mesh set to 8 CPU devices (JAX's is mesh8 under
    tests/conftest.py), restored afterwards."""
    saved = port_mesh._default_mesh
    yield force_cpu_devices(8)
    port_mesh.set_default_mesh(saved)


def _trio(emb, mesh8, pmesh8, dtype="f32", **kw):
    """JAX's database on mesh8, the port's on the 8-device CPU mesh, the
    port's on one CPU device."""
    jdt, tdt = DTYPES[dtype]
    return (jax_db.ShardedEmbeddingDatabase(emb, dtype=jdt, mesh=mesh8, **kw),
            port_db.ShardedEmbeddingDatabase(emb, dtype=tdt, mesh=pmesh8, **kw),
            port_db.ShardedEmbeddingDatabase(emb, dtype=tdt, device="cpu", **kw))


def _assert_same(jres, tres, dtype="f32"):
    (jv, ji), (tv, ti) = jres, tres
    jv, ji = np.asarray(jv, np.float32), np.asarray(ji)
    assert ti.dtype == torch.int32 and tv.dtype == torch.float32
    if dtype == "bf16":
        np.testing.assert_array_equal(ti.numpy()[:, 0], ji[:, 0])
        np.testing.assert_allclose(tv.numpy(), jv, atol=1e-2)
    else:
        np.testing.assert_array_equal(ti.numpy(), ji)
        np.testing.assert_allclose(tv.numpy(), jv, rtol=0, atol=1e-6)


def _assert_bitwise(got, want):
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("n", [64, 100, 1000, 37, 5])
def test_sharded_topk_matches_jax(mesh8, pmesh8, rng, n, dtype):
    """n not divisible by 8 leaves a short shard; n = 5 leaves three
    empty ones (shard_size 1); k = 5 exceeds every shard at n = 37."""
    db = rng.randn(n, 48).astype(np.float32)
    queries = rng.randn(6, 48).astype(np.float32)
    jdb, tdb, one = _trio(db, mesh8, pmesh8, dtype)
    assert len(tdb.shards) == 8 and tdb.shard_size == -(-n // 8) == jdb.shard_size
    for k in (1, 5):
        got = tdb.topk(queries, k)
        _assert_same(jdb.topk(queries, k), got, dtype)
        _assert_bitwise(got, one.topk(queries, k))


@pytest.mark.parametrize("use_pallas", [False, True])
def test_empty_and_short_shards_use_pallas(mesh8, pmesh8, rng, use_pallas):
    """K6's plain version per shard (``n_valid`` = the shard's valid rows)
    and the plain scan give JAX's answer with empty and short shards."""
    emb = rng.randn(19, 16).astype(np.float32)      # shard_size 3: 6 full, 1 row, empty
    q = rng.randn(4, 16).astype(np.float32)
    jdb = jax_db.ShardedEmbeddingDatabase(emb, mesh=mesh8)
    tdb = port_db.ShardedEmbeddingDatabase(emb, mesh=pmesh8, use_pallas=use_pallas)
    one = port_db.ShardedEmbeddingDatabase(emb, device="cpu", use_pallas=use_pallas)
    assert [min(max(tdb.n - i * 3, 0), 3) for i in range(8)] == [3] * 6 + [1, 0]
    for k in (2, 3, 7):
        _assert_same(jdb.topk(q, k), tdb.topk(q, k))
        _assert_bitwise(tdb.topk(q, k), one.topk(q, k))


def test_shard_functions_skip_empty_shards(rng):
    """``shard_topk`` gives an empty shard no candidates and a short one
    only its valid rows; ``merge_topk`` of the shards equals one scan."""
    emb = torch.from_numpy(rng.randn(10, 8).astype(np.float32))
    emb = emb / emb.norm(dim=1, keepdim=True)
    q = emb[:2] + 0.1
    slabs = [torch.cat([emb[i * 4:(i + 1) * 4], torch.zeros(4, 8)])[:4] for i in range(4)]
    parts = [port_db.shard_topk(q, s, None, min(max(10 - 4 * i, 0), 4), 4 * i, 4, False)
             for i, s in enumerate(slabs)]
    assert parts[3] is None and parts[2][1].shape == (2, 2)
    vals, idx = port_db.merge_topk(parts, 6, torch.device("cpu"))
    want = port_db.ShardedEmbeddingDatabase(emb.numpy(), device="cpu", normalize=False)
    _assert_bitwise((vals, idx), want._scan(q, 6))


def test_search_metadata_and_single_query(mesh8, pmesh8, rng):
    n, dim = 40, 16
    db = rng.randn(n, dim).astype(np.float32)
    labels = [f"L{i % 4}" for i in range(n)]
    ids = [f"p{i:03d}" for i in range(n)]
    jdb, tdb, _ = _trio(db, mesh8, pmesh8, labels=labels, ids=ids)
    hits = tdb.search(db[:3], k=3)
    want = jdb.search(db[:3], k=3)
    for got_q, want_q in zip(hits, want):
        assert [(h["index"], h["label"], h["patient_id"]) for h in got_q] == \
            [(h["index"], h["label"], h["patient_id"]) for h in want_q]
        np.testing.assert_allclose([h["score"] for h in got_q],
                                   [h["score"] for h in want_q], atol=1e-6)
    for qi in range(3):
        assert hits[qi][0]["index"] == qi and hits[qi][0]["patient_id"] == ids[qi]
    _, idx = tdb.topk(db[7], k=1)
    assert idx.shape == (1, 1) and int(idx[0, 0]) == 7


def test_k_clamped_to_n(mesh8, pmesh8, rng):
    db0 = rng.randn(10, 8).astype(np.float32)
    jdb, tdb, one = _trio(db0, mesh8, pmesh8, labels=[f"L{i}" for i in range(10)])
    hits = tdb.search(db0[:1], k=25)
    assert len(hits[0]) == 10 and all(h["score"] > -1.0 for h in hits[0])
    _assert_same(jdb.topk(db0[:2], 25), tdb.topk(db0[:2], 25))
    _assert_bitwise(tdb.topk(db0[:2], 25), one.topk(db0[:2], 25))


@pytest.mark.parametrize("dtype", ["f32", "int8"])
def test_add_cases_and_persistence_across_packages(mesh8, pmesh8, rng, tmp_path, dtype):
    """add_cases, then save: each package loads the other's npz onto its
    8-device mesh and answers as the saving one does."""
    db0 = rng.randn(20, 16).astype(np.float32)
    meta = dict(labels=[f"L{i % 2}" for i in range(20)], ids=[f"p{i}" for i in range(20)])
    jdb, tdb, one = _trio(db0, mesh8, pmesh8, dtype, **meta)
    extra = rng.randn(7, 16).astype(np.float32)
    for db in (jdb, tdb, one):
        db.add_cases(extra, labels=["LX"] * 7, ids=[f"x{i}" for i in range(7)])
    assert tdb.n == 27 and tdb.search(extra[3][None, :], k=1)[0][0]["patient_id"] == "x3"
    with pytest.raises(ValueError, match="dim"):
        tdb.add_cases(rng.randn(2, 8).astype(np.float32), labels=["LZ"] * 2,
                      ids=["z0", "z1"])
    assert tdb.n == 27 and len(tdb.labels) == 27 and len(tdb.ids) == 27
    q = db0[:4] + 0.1 * rng.randn(4, 16).astype(np.float32)
    _assert_same(jdb.topk(q, 3), tdb.topk(q, 3), dtype)
    _assert_bitwise(tdb.topk(q, 3), one.topk(q, 3))
    jdb.save(tmp_path / "jax.npz")
    tdb.save(tmp_path / "port.npz")
    jdt, tdt = DTYPES[dtype]
    from_jax = port_db.ShardedEmbeddingDatabase.load(tmp_path / "jax.npz", mesh=pmesh8, dtype=tdt)
    from_port = jax_db.ShardedEmbeddingDatabase.load(tmp_path / "port.npz", mesh=mesh8, dtype=jdt)
    assert from_jax.n == from_port.n == 27 and from_jax.ids == from_port.ids == jdb.ids
    assert from_jax.labels[-1] == "LX"
    _assert_same(from_port.topk(q, 3), from_jax.topk(q, 3), dtype)
    _assert_bitwise(from_jax.topk(q, 3), tdb.topk(q, 3))


def test_int8_quantized_mode(mesh8, pmesh8, rng):
    n, dim, q, k = 400, 64, 16, 5
    db = rng.randn(n, dim).astype(np.float32)
    queries = db[:q] + 0.05 * rng.randn(q, dim).astype(np.float32)
    jdb, tdb, one = _trio(db, mesh8, pmesh8, "int8")
    _assert_same(jdb.topk(queries, k), tdb.topk(queries, k), "int8")
    _assert_bitwise(tdb.topk(queries, k), one.topk(queries, k))
    extra = rng.randn(3, dim).astype(np.float32)
    jdb.add_cases(extra)
    tdb.add_cases(extra)
    _assert_same(jdb.topk(extra, 2), tdb.topk(extra, 2), "int8")
    assert int(tdb.topk(extra[:1], k=1)[1][0, 0]) == n


@pytest.mark.parametrize("dtype", ["f32", "int8"])
def test_capacity_streams_in_place_then_grows(mesh8, pmesh8, rng, dtype):
    """Within the reserved capacity add_cases writes rows into their shards
    in place (a batch that straddles two shards too); past it the shards
    grow; every answer equals JAX's."""
    db0 = rng.randn(16, 8).astype(np.float32)
    jdb, tdb, _ = _trio(db0, mesh8, pmesh8, dtype, capacity=64,
                        ids=[f"p{i}" for i in range(16)])
    assert tdb.shard_size == 8
    bufs = [s.data_ptr() for s in tdb.shards]
    for batch in range(3):
        extra = rng.randn(5, 8).astype(np.float32)
        new_ids = [f"b{batch}_{i}" for i in range(5)]
        jdb.add_cases(extra, ids=new_ids)
        tdb.add_cases(extra, ids=new_ids)
        assert tdb.search(extra[2][None, :], k=1)[0][0]["patient_id"] == f"b{batch}_2"
    assert [s.data_ptr() for s in tdb.shards] == bufs and tdb.n == 31
    assert all(s.shape == (8, 8) for s in tdb.shards)
    assert tdb.search(db0[1][None, :], k=1)[0][0]["patient_id"] == "p1"
    queries = rng.randn(4, 8).astype(np.float32)
    _assert_same(jdb.topk(queries, 5), tdb.topk(queries, 5), dtype)
    overflow = rng.randn(50, 8).astype(np.float32)
    jdb.add_cases(overflow, ids=[f"z{i}" for i in range(50)])
    tdb.add_cases(overflow, ids=[f"z{i}" for i in range(50)])
    assert tdb.n == 81 and tdb.capacity == 128 and tdb.shard_size == 16
    _assert_same(jdb.topk(queries, 5), tdb.topk(queries, 5), dtype)
    host = port_db.ShardedEmbeddingDatabase(tdb._host_emb, device="cpu", normalize=False,
                                            dtype=DTYPES[dtype][1])
    _assert_bitwise(tdb.topk(queries, 5), host.topk(queries, 5))


def test_capacity_geometric_growth(pmesh8, rng):
    db = port_db.ShardedEmbeddingDatabase(
        rng.randn(16, 32).astype(np.float32), mesh=pmesh8, capacity=24)
    rebuilds = [0]
    orig = db._upload
    db._upload = lambda: (rebuilds.__setitem__(0, rebuilds[0] + 1), orig())
    for _ in range(20):
        db.add_cases(rng.randn(8, 32).astype(np.float32))
    assert db.n == 176 and rebuilds[0] <= 4
    q = rng.randn(3, 32).astype(np.float32)
    _, idx = db.topk(q, 5)
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    np.testing.assert_array_equal(idx.numpy(),
                                  np.argsort(-(qn @ db._host_emb.T), axis=1)[:, :5])


def test_metadata_alignment_enforced(pmesh8, rng):
    db = port_db.ShardedEmbeddingDatabase(rng.randn(8, 4).astype(np.float32), mesh=pmesh8)
    with pytest.raises(ValueError, match="labels"):
        db.add_cases(rng.randn(2, 4).astype(np.float32), labels=["x", "y"])
    db2 = port_db.ShardedEmbeddingDatabase(rng.randn(8, 4).astype(np.float32),
                                           labels=["a"] * 8, mesh=pmesh8)
    with pytest.raises(ValueError, match="labels"):
        db2.add_cases(rng.randn(2, 4).astype(np.float32))
    with pytest.raises(ValueError, match="len"):
        db2.add_cases(rng.randn(2, 4).astype(np.float32), labels=["only-one"])


@pytest.mark.parametrize("dtype", ["f32", "int8"])
def test_topk_chained_matches_unchained(pmesh8, rng, dtype):
    emb = rng.randn(40, 16).astype(np.float32)
    q = rng.randn(16).astype(np.float32)
    db = port_db.ShardedEmbeddingDatabase(emb, mesh=pmesh8, dtype=DTYPES[dtype][1])
    vref, iref = db.topk(q, k=5)
    vch, ich = db.topk_chained(q, k=5, repeats=7)
    np.testing.assert_array_equal(ich.numpy(), iref.numpy())
    np.testing.assert_allclose(vch.numpy(), vref.numpy(), rtol=1e-5, atol=1e-6)


def _write_step2_npz(path, rng, pids, centers, dim=16):
    payload = {p: (centers[i % len(centers)][None, :] + rng.randn(3, dim) * 0.05
                   ).astype(np.float32) for i, p in enumerate(pids)}
    np.savez_compressed(path, **payload)


def _write_manifest(path, pids, labels):
    with open(path, "w", encoding="utf-8") as f:
        for p, l in zip(pids, labels):
            f.write(json.dumps({"patient_id": p, "label": l}) + "\n")


def _hits(path):
    return [json.loads(l) for l in path.read_text().splitlines()]


@pytest.mark.parametrize("dtype", ["f32", "int8"])
def test_cli_build_query_add_on_the_default_mesh(mesh8, rng, tmp_path, dtype,
                                                 cpu_default_mesh, caplog):
    """Both CLIs on their default meshes, 8 CPU devices each: build from a
    step2 npz with manifest labels, query, add new cases (ids already
    present skipped), query again; the port's hits are JAX's, and it logs
    the shard count."""
    centers = rng.randn(4, 16) * 3
    pids = [f"p{i:03d}" for i in range(24)]
    labels = [f"L{i % 4}" for i in range(24)]
    _write_step2_npz(tmp_path / "embeddings.npz", rng, pids, centers)
    _write_manifest(tmp_path / "manifest.jsonl", pids, labels)
    new_pids = pids[:2] + [f"q{i:03d}" for i in range(8)]
    _write_step2_npz(tmp_path / "new.npz", rng, new_pids, centers)
    _write_manifest(tmp_path / "new_manifest.jsonl", new_pids,
                    [f"L{i % 4}" for i in range(len(new_pids))])
    out = {}
    with caplog.at_level(logging.INFO, logger="emr2a_tpu_torch.retrieval.database_cli"):
        for name, main in (("jax", jax_cli.main), ("port", port_cli.main)):
            d = tmp_path / name
            main(["build", "--embeddings_path", str(tmp_path / "embeddings.npz"),
                  "--manifest_path", str(tmp_path / "manifest.jsonl"),
                  "--db", str(d / "db.npz"), "--capacity", "64", "--dtype", dtype])
            main(["query", "--db", str(d / "db.npz"), "--queries_path",
                  str(tmp_path / "embeddings.npz"), "--k", "3", "--dtype", dtype,
                  "--output", str(d / "hits1.jsonl")])
            main(["add", "--db", str(d / "db.npz"), "--embeddings_path",
                  str(tmp_path / "new.npz"), "--manifest_path",
                  str(tmp_path / "new_manifest.jsonl"), "--dtype", dtype])
            main(["query", "--db", str(d / "db.npz"), "--queries_path",
                  str(tmp_path / "new.npz"), "--k", "2", "--dtype", dtype,
                  "--output", str(d / "hits2.jsonl")])
            out[name] = (_hits(d / "hits1.jsonl"), _hits(d / "hits2.jsonl"))
    for got, want in zip(out["port"], out["jax"]):
        assert [r["query_id"] for r in got] == [r["query_id"] for r in want]
        for g, w in zip(got, want):
            assert [(h["index"], h["label"], h["patient_id"]) for h in g["hits"]] == \
                [(h["index"], h["label"], h["patient_id"]) for h in w["hits"]]
            np.testing.assert_allclose([h["score"] for h in g["hits"]],
                                       [h["score"] for h in w["hits"]], atol=1e-6)
    assert sum("sharded over 8 device(s)" in r.message for r in caplog.records) == 4
    db = port_db.ShardedEmbeddingDatabase.load(tmp_path / "port" / "db.npz",
                                               mesh=cpu_default_mesh)
    assert db.n == 32 and db.ids[-1] == "q007"


def test_cli_matrix_form_and_cpu_flag(rng, tmp_path, cpu_default_mesh):
    """The matrix layout builds the database the per-key layout builds on
    the default mesh; ``--cpu`` (one CPU device) writes the same hits."""
    emb = rng.randn(24, 16).astype(np.float32)
    ids = [f"p{i:03d}" for i in range(24)]
    np.savez(tmp_path / "perkey.npz", **{pid: emb[i][None] for i, pid in enumerate(ids)})
    np.savez(tmp_path / "matrix.npz", patient_ids=np.asarray(ids), image_matrix=emb)
    np.savez(tmp_path / "queries.npz", patient_ids=np.asarray(ids[:4]), image_matrix=emb[:4])
    hits = {}
    for form, flags in (("perkey", []), ("matrix", []), ("matrix_cpu", ["--cpu"])):
        src = form.split("_")[0]
        port_cli.main(["build", "--embeddings_path", str(tmp_path / f"{src}.npz"),
                       "--db", str(tmp_path / f"db_{form}.npz"), "--dtype", "int8", *flags])
        port_cli.main(["query", "--db", str(tmp_path / f"db_{form}.npz"),
                       "--queries_path", str(tmp_path / "queries.npz"), "--k", "3",
                       "--dtype", "int8", "--repeat", "3",
                       "--output", str(tmp_path / f"hits_{form}.jsonl"), *flags])
        hits[form] = _hits(tmp_path / f"hits_{form}.jsonl")
    assert hits["matrix"] == hits["perkey"] == hits["matrix_cpu"]
    for row in hits["matrix"]:
        assert row["hits"][0]["patient_id"] == row["query_id"]
