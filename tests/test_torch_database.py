"""The port's one-device embedding database and its CLI against
``emr2a_tpu.retrieval.database`` on the same inputs, on the CPU (the
plain versions of K6).

Tolerances: f32 and int8 give the same indices as JAX and values within
1e-6 (f32 sums in another order; int8 sums are exact). bf16 normalises the
query in bf16 in both packages, where JAX squares in bf16 and PyTorch in
f32, so bf16 is held to the top-1 neighbour and values within 1e-2.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emr2a_tpu.retrieval import database as jax_db
from emr2a_tpu.retrieval import database_cli as jax_cli
from emr2a_tpu_torch.ops import topk as port_topk
from emr2a_tpu_torch.retrieval import database as port_db
from emr2a_tpu_torch.retrieval import database_cli as port_cli

torch.set_num_threads(1)

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16),
          "int8": (jnp.int8, torch.int8)}


def _pair(emb, dtype="f32", **kw):
    jdt, tdt = DTYPES[dtype]
    return (jax_db.ShardedEmbeddingDatabase(emb, dtype=jdt, **kw),
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


@pytest.mark.parametrize("n", [64, 100, 1000, 37])
def test_full_scan_matches_jax(rng, n):
    db = rng.randn(n, 48).astype(np.float32)
    queries = rng.randn(6, 48).astype(np.float32)
    jdb, tdb = _pair(db)
    _assert_same(jdb.topk(queries, 5), tdb.topk(queries, 5))


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_dtypes_match_jax(rng, dtype):
    emb = rng.randn(400, 64).astype(np.float32)
    queries = emb[:16] + 0.05 * rng.randn(16, 64).astype(np.float32)
    jdb, tdb = _pair(emb, dtype)
    _assert_same(jdb.topk(queries, 5), tdb.topk(queries, 5), dtype)
    # ingestion in the storage dtype
    extra = rng.randn(3, 64).astype(np.float32)
    jdb.add_cases(extra)
    tdb.add_cases(extra)
    _assert_same(jdb.topk(extra, 3), tdb.topk(extra, 3), dtype)
    assert int(tdb.topk(extra[:1], 1)[1][0, 0]) == 400


def test_search_metadata_single_vector_and_k_clamp(rng):
    db = rng.randn(40, 16).astype(np.float32)
    labels = [f"L{i % 4}" for i in range(40)]
    ids = [f"p{i:03d}" for i in range(40)]
    jdb, tdb = _pair(db, labels=labels, ids=ids)
    got = tdb.search(db[:3], k=3)
    want = jdb.search(db[:3], k=3)
    assert [[(h["index"], h["label"], h["patient_id"]) for h in row] for row in got] \
        == [[(h["index"], h["label"], h["patient_id"]) for h in row] for row in want]
    for qi in range(3):
        assert got[qi][0]["index"] == qi and got[qi][0]["score"] == pytest.approx(1.0, abs=1e-4)
    # a single (dim,) query vector
    assert int(tdb.topk(db[7], k=1)[1][0, 0]) == 7
    # k beyond the number of cases is clamped, with no filler candidates
    small = port_db.ShardedEmbeddingDatabase(db[:10], device="cpu")
    hits = small.search(db[:1], k=25)
    assert len(hits[0]) == 10 and all(h["score"] > -1.0 for h in hits[0])


@pytest.mark.parametrize("saver", ["jax", "port"])
def test_persistence_across_packages(rng, tmp_path, saver):
    """A db.npz written by either package loads in the other with the same
    rows, labels and ids, and both answer alike."""
    db0 = rng.randn(20, 16).astype(np.float32)
    labels, ids = [f"L{i % 2}" for i in range(20)], [f"p{i}" for i in range(20)]
    jdb, tdb = _pair(db0, labels=labels, ids=ids)
    extra = rng.randn(7, 16).astype(np.float32)
    for db in (jdb, tdb):
        db.add_cases(extra, labels=["LX"] * 7, ids=[f"x{i}" for i in range(7)])
    path = tmp_path / "db.npz"
    (jdb if saver == "jax" else tdb).save(path)
    jl = jax_db.ShardedEmbeddingDatabase.load(path)
    tl = port_db.ShardedEmbeddingDatabase.load(path, device="cpu")
    np.testing.assert_array_equal(tl._host_emb, jl._host_emb)
    assert tl.labels == jl.labels and tl.ids == jl.ids and tl.n == jl.n == 27
    assert tl.labels[-1] == "LX" and tl.ids[0] == "p0"
    _assert_same(jl.topk(db0[:4], 3), tl.topk(db0[:4], 3))
    # a failed append (wrong width) touches neither rows nor metadata
    with pytest.raises(ValueError, match="dim"):
        tl.add_cases(rng.randn(2, 8).astype(np.float32), labels=["LZ"] * 2,
                     ids=["z0", "z1"])
    assert tl.n == 27 and len(tl.labels) == 27 and len(tl.ids) == 27


@pytest.mark.parametrize("dtype", ["f32", "int8"])
def test_capacity_streams_in_place_then_grows(rng, dtype):
    """Within the reserved capacity add_cases writes rows into the same
    device buffer; past it the buffer grows, and every answer stays equal
    to JAX's."""
    db0 = rng.randn(16, 8).astype(np.float32)
    jdb, tdb = _pair(db0, dtype, capacity=64, ids=[f"p{i}" for i in range(16)])
    buf = tdb.db.data_ptr()
    for batch in range(3):
        extra = rng.randn(5, 8).astype(np.float32)
        new_ids = [f"b{batch}_{i}" for i in range(5)]
        jdb.add_cases(extra, ids=new_ids)
        tdb.add_cases(extra, ids=new_ids)
        assert tdb.search(extra[2][None, :], k=1)[0][0]["patient_id"] == f"b{batch}_2"
    assert tdb.db.data_ptr() == buf and tdb.db.shape == (64, 8) and tdb.n == 31
    queries = rng.randn(4, 8).astype(np.float32)
    _assert_same(jdb.topk(queries, 5), tdb.topk(queries, 5), dtype)
    overflow = rng.randn(50, 8).astype(np.float32)
    jdb.add_cases(overflow, ids=[f"z{i}" for i in range(50)])
    tdb.add_cases(overflow, ids=[f"z{i}" for i in range(50)])
    assert tdb.n == 81 and tdb.capacity == 128 and tdb.db.shape[0] == 128
    _assert_same(jdb.topk(queries, 5), tdb.topk(queries, 5), dtype)


def test_capacity_geometric_growth(rng):
    db = port_db.ShardedEmbeddingDatabase(
        rng.randn(16, 32).astype(np.float32), capacity=24, device="cpu")
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


def test_metadata_alignment_and_mesh_rejected(rng):
    db = port_db.ShardedEmbeddingDatabase(rng.randn(8, 4).astype(np.float32),
                                          device="cpu")
    with pytest.raises(ValueError, match="labels"):
        db.add_cases(rng.randn(2, 4).astype(np.float32), labels=["x", "y"])
    db2 = port_db.ShardedEmbeddingDatabase(rng.randn(8, 4).astype(np.float32),
                                           labels=["a"] * 8, device="cpu")
    with pytest.raises(ValueError, match="labels"):
        db2.add_cases(rng.randn(2, 4).astype(np.float32))
    with pytest.raises(ValueError, match="len"):
        db2.add_cases(rng.randn(2, 4).astype(np.float32), labels=["only-one"])
    with pytest.raises(ValueError, match="mesh"):
        port_db.ShardedEmbeddingDatabase(rng.randn(8, 4).astype(np.float32),
                                         mesh=object(), device="cpu")


@pytest.mark.parametrize("dtype,use_pallas", [("f32", False), ("f32", True),
                                              ("bf16", False), ("bf16", True),
                                              ("int8", False)])
def test_topk_chained_equals_unchained(rng, dtype, use_pallas):
    emb = rng.randn(40, 16).astype(np.float32)
    q = rng.randn(16).astype(np.float32)
    db = port_db.ShardedEmbeddingDatabase(emb, dtype=DTYPES[dtype][1],
                                          use_pallas=use_pallas, device="cpu")
    vref, iref = db.topk(q, k=5)
    vch, ich = db.topk_chained(q, k=5, repeats=7)
    np.testing.assert_array_equal(ich.numpy(), iref.numpy())
    np.testing.assert_allclose(vch.numpy(), vref.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_use_pallas_on_a_padded_buffer_equals_jax(rng, dtype):
    """K6 takes n_valid, so use_pallas stays on under capacity padding
    (JAX turns it off and scans with XLA); the answers are the same."""
    emb = rng.randn(20, 16).astype(np.float32)
    q = rng.randn(3, 16).astype(np.float32)
    jdb, _ = _pair(emb, dtype)
    tdb = port_db.ShardedEmbeddingDatabase(emb, dtype=DTYPES[dtype][1],
                                           use_pallas=True, capacity=64,
                                           device="cpu")
    before = port_topk.LAUNCHES
    _assert_same(jdb.topk(q, k=5), tdb.topk(q, k=5), dtype)
    assert tdb.db.shape[0] == 64 and port_topk.LAUNCHES == before   # CPU: plain version


def test_quantize_rows_int8_byte_identical_to_jax(rng):
    """The DB's recipe (amax / 127, a zero row scaled by 1, rint) on zero
    rows, exact halves and large magnitudes."""
    x = rng.randn(32, 24).astype(np.float32) * np.exp(rng.randn(32, 1) * 3)
    x[0] = 0.0
    x[1, :3] = [127.0, 0.5, -1.5]       # scale 1: codes at x.5 ties
    x[1, 3:] = 0.0
    x[2] = np.linspace(-1, 1, 24)
    want_q, want_s = jax_db.quantize_rows_int8(x)
    got_q, got_s = port_db.quantize_rows_int8(x)
    assert got_q.dtype == np.int8 and got_s.dtype == np.float32
    assert got_q.tobytes() == want_q.tobytes() and got_s.tobytes() == want_s.tobytes()
    assert got_s[0] == 1.0 and (got_q[0] == 0).all()
    assert got_q[1, :3].tolist() == [127, 0, -2]


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


def _assert_hits_equal(got, want, dtype):
    assert [r["query_id"] for r in got] == [r["query_id"] for r in want]
    for g, w in zip(got, want):
        key = (lambda h: (h["label"],)) if dtype == "bf16" else \
            (lambda h: (h["index"], h["label"], h["patient_id"]))
        assert [key(h) for h in g["hits"]] == [key(h) for h in w["hits"]]
        np.testing.assert_allclose([h["score"] for h in g["hits"]],
                                   [h["score"] for h in w["hits"]],
                                   atol=1e-2 if dtype == "bf16" else 1e-6)


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_cli_build_query_add_matches_jax(rng, tmp_path, dtype):
    """build from a step2 embeddings.npz with manifest labels, query, add
    new cases (already present ids skipped), query again: the port's CLI
    with --cpu writes the JAX CLI's hits."""
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
    for name, main in (("jax", jax_cli.main), ("port", port_cli.main)):
        d = tmp_path / name
        main(["build", "--embeddings_path", str(tmp_path / "embeddings.npz"),
              "--manifest_path", str(tmp_path / "manifest.jsonl"),
              "--db", str(d / "db.npz"), "--capacity", "64", "--dtype", dtype,
              "--cpu"])
        main(["query", "--db", str(d / "db.npz"), "--queries_path",
              str(tmp_path / "embeddings.npz"), "--k", "3", "--dtype", dtype,
              "--output", str(d / "hits1.jsonl"), "--cpu"])
        main(["add", "--db", str(d / "db.npz"), "--embeddings_path",
              str(tmp_path / "new.npz"), "--manifest_path",
              str(tmp_path / "new_manifest.jsonl"), "--dtype", dtype, "--cpu"])
        main(["query", "--db", str(d / "db.npz"), "--queries_path",
              str(tmp_path / "new.npz"), "--k", "2", "--dtype", dtype,
              "--output", str(d / "hits2.jsonl"), "--cpu"])
        out[name] = (_hits(d / "hits1.jsonl"), _hits(d / "hits2.jsonl"))
    for got, want in zip(out["port"], out["jax"]):
        _assert_hits_equal(got, want, dtype)
    rows = out["port"][0]
    assert len(rows) == 24 and len(out["port"][1]) == 10
    for row in rows:
        assert row["hits"][0]["label"] == labels[pids.index(row["query_id"])]
    db = port_db.ShardedEmbeddingDatabase.load(tmp_path / "port" / "db.npz", device="cpu")
    assert db.n == 32 and db.ids[-1] == "q007"


def test_cli_matrix_form_ingest(rng, tmp_path):
    """The matrix layout (patient_ids + image_matrix) builds the database
    the per-key layout builds."""
    emb = rng.randn(24, 16).astype(np.float32)
    ids = [f"p{i:03d}" for i in range(24)]
    np.savez(tmp_path / "perkey.npz", **{pid: emb[i][None] for i, pid in enumerate(ids)})
    np.savez(tmp_path / "matrix.npz", patient_ids=np.asarray(ids), image_matrix=emb)
    np.savez(tmp_path / "queries.npz", patient_ids=np.asarray(ids[:4]),
             image_matrix=emb[:4])
    hits = {}
    for form in ("perkey", "matrix"):
        port_cli.main(["build", "--embeddings_path", str(tmp_path / f"{form}.npz"),
                       "--db", str(tmp_path / f"db_{form}.npz"), "--dtype", "int8",
                       "--cpu"])
        port_cli.main(["query", "--db", str(tmp_path / f"db_{form}.npz"),
                       "--queries_path", str(tmp_path / "queries.npz"), "--k", "3",
                       "--dtype", "int8", "--repeat", "3", "--cpu",
                       "--output", str(tmp_path / f"hits_{form}.jsonl")])
        hits[form] = _hits(tmp_path / f"hits_{form}.jsonl")
    assert hits["matrix"] == hits["perkey"]
    for row in hits["matrix"]:
        assert row["hits"][0]["patient_id"] == row["query_id"]


def test_cli_chained_needs_the_card(rng, tmp_path):
    """--chained times the device with CUDA events; with --cpu it refuses
    instead of reporting a host number as a device p50."""
    emb = rng.randn(24, 16).astype(np.float32)
    np.savez(tmp_path / "emb.npz", patient_ids=np.asarray([f"p{i}" for i in range(24)]),
             image_matrix=emb)
    port_cli.main(["build", "--embeddings_path", str(tmp_path / "emb.npz"),
                   "--db", str(tmp_path / "db.npz"), "--cpu"])
    with pytest.raises(SystemExit, match="CUDA events"):
        port_cli.main(["query", "--db", str(tmp_path / "db.npz"),
                       "--queries_path", str(tmp_path / "emb.npz"), "--k", "3",
                       "--repeat", "8", "--chained", "--cpu",
                       "--output", str(tmp_path / "hits.jsonl")])
