"""The sharded database with one process a shard: a rank of ``torchrun``.

    python -m torch.distributed.run --standalone --nproc-per-node N \\
        -m emr2a_tpu_torch.tools.db_processes --case jax|cases|measure [--dir DIR]

(``parallel.launch.launch`` runs that.) Every rank reads ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT`` from
the environment ``torchrun`` sets, joins ``torch.distributed`` through
``initialize_distributed`` and builds the database over the mesh that
spans the processes, one shard each. ``--case jax`` and ``--case cases``
run on the CPU over gloo, one CPU device a rank; ``--case measure`` runs
on the cards, rank R on ``cuda:R`` over NCCL, or with ``--one_card`` every
rank on ``cuda:0`` over gloo (NCCL takes one process a card).

``--case jax``: JAX's two-process worker (``tests/helpers/dcn_worker.py``)
on the port: a 16 × 8 matrix from ``RandomState(0)`` (the same on every
rank), 8 rows a process, ``n_total`` = 14 (rows 14 and 15 real but
masked), k = 5; each rank hands over only its slab (``shard_topk``,
``pack_candidates``, ``all_gather_candidates``, ``merge_gathered``), then
the same through ``ShardedEmbeddingDatabase(capacity=16)``; indices equal
numpy's and values within rtol 1e-5.

``--case cases``: the mesh's refusals across processes, then every case of
``CASES`` in f32, bf16 and int8 on the same seeded rows on every rank; the
inputs and answers go to ``DIR/rank{R}.npz`` for the caller to hold against
the JAX package (``tests/test_torch_processes.py``).

``--case measure``: the rows in ``DIR/emb.npy`` and the 64 queries in
``DIR/batch.npy`` (written by the caller, ``seeded_rows``; each rank maps
the file and reads only its own shard's rows) in f32, bf16 (``use_pallas``:
K6) and int8 (K6's int8 variant). The counts are set to 0, then the
searches at q = 1 (k = 5) and q = 64 (k = 5 and 100) run, and the counts
are read: K6's launches by this rank. The answers go to
``DIR/rank{R}_{dtype}.npz`` for the caller to compare. Then, unless
``--no_timings``, the timings, on each rank's card with CUDA events: the
single-query p50 of ``database_cli.chained_p50_ms`` (3 runs of 256
chained searches), each of 256 searches timed alone (p50 and quartiles),
split into the scan (the query's copy, K6, the packing), the all-gather
and the merge (medians), and the host clock per search; the q = 64, k = 5
search (median of 20). Each rank writes ``DIR/rank{R}.json``; rank 0
prints a line a dtype.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

DIM = 512
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}
CHECKS = ((1, 5), (64, 5), (64, 100))

# --case cases: (rows, dim, queries, ks, capacity); see run_case
CASES = {
    "plain": (100, 48, 6, (1, 5), None),
    "k_over_shard": (10, 16, 4, (7,), None),
    "short_last": (37, 32, 5, (5, 12), None),
    "empty_shard": (3, 8, 2, (3,), None),
    "add_past_capacity": (16, 16, 4, (5,), 20),
    "search": (40, 16, 3, (3,), None),
}


def seeded_rows(rows: int, seed: int = 0):
    """(rows x 512 unit rows, 64 queries near 64 of them): the data of
    ``multichip_smoke``'s phase b for ``seed`` 0."""
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((rows, DIM), dtype=np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True) + 1e-12
    picks = rng.choice(rows, 64, replace=False)
    batch = emb[picks] + 0.1 * rng.standard_normal((64, DIM), dtype=np.float32)
    return emb, batch


def write_rows(directory: Path, emb: np.ndarray, batch: np.ndarray) -> None:
    """The ``--case measure`` inputs: ``emb.npy`` and ``batch.npy``."""
    directory.mkdir(parents=True, exist_ok=True)
    np.save(directory / "emb.npy", emb)
    np.save(directory / "batch.npy", batch)


def spanning_mesh(device: torch.device):
    """The (processes, 1) mesh of every rank's device: ``default_mesh()``
    over each rank's ``local_device_ids``, or one CPU device a rank."""
    from emr2a_tpu_torch.parallel import default_mesh, force_cpu_devices
    return force_cpu_devices(1) if device.type == "cpu" else default_mesh()


def jax_case(device: torch.device) -> None:
    """JAX's worker shapes (module docstring); raises where an answer
    differs from numpy's."""
    from emr2a_tpu_torch.parallel import process_index
    from emr2a_tpu_torch.retrieval.database import (
        ShardedEmbeddingDatabase,
        all_gather_candidates,
        merge_gathered,
        pack_candidates,
        shard_topk,
    )

    pid = process_index()
    rng = np.random.RandomState(0)           # the same on every rank
    db = rng.randn(16, 8).astype(np.float32)
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    queries = rng.randn(3, 8).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    shard_size, n_total, k = 8, 14, 5
    base = pid * shard_size
    slab = torch.from_numpy(db[base:base + shard_size]).to(device)
    q = torch.from_numpy(queries).to(device)
    cand = shard_topk(q, slab, None, int(np.clip(n_total - base, 0, shard_size)), base,
                      min(k, shard_size), False)
    gathered = all_gather_candidates(pack_candidates([cand], 3, k, 1, device))
    order = torch.arange(gathered.shape[0], device=device)
    vals, idx = merge_gathered(gathered, order, k)
    scores = queries @ db[:n_total].T
    ref_idx = np.argsort(-scores, axis=1, kind="stable")[:, :k]
    ref_vals = np.take_along_axis(scores, ref_idx, axis=1)
    np.testing.assert_array_equal(idx.cpu().numpy(), ref_idx)
    np.testing.assert_allclose(vals.cpu().numpy(), ref_vals, rtol=1e-5)
    mesh = spanning_mesh(device)
    if mesh.is_local:
        raise AssertionError("the mesh does not span the processes")
    whole = ShardedEmbeddingDatabase(db[:n_total], mesh=mesh, capacity=16, normalize=False)
    assert whole.shard_size == shard_size and whole.shard_ids == [pid]
    vals, idx = whole.topk(queries, k, normalize=False)
    np.testing.assert_array_equal(idx.cpu().numpy(), ref_idx)
    np.testing.assert_allclose(vals.cpu().numpy(), ref_vals, rtol=1e-5)
    print(f"p{pid}: sharded retrieval over processes OK", flush=True)


def mesh_checks(rank: int, n: int) -> None:
    """A process-spanning mesh refuses to place or read another process's
    data; (process, cuda:0) pairs are distinct devices."""
    from emr2a_tpu_torch.parallel import (
        Mesh,
        check_mesh,
        data_devices,
        default_mesh,
        replicated,
        shard_batch,
        shard_owners,
    )

    mesh = default_mesh()
    assert not mesh.is_local and mesh.shape == {"data": n, "model": 1}
    assert [p for p, _ in shard_owners(mesh)] == list(range(n))
    for fn in (lambda: data_devices(mesh), lambda: shard_batch(torch.zeros(n, 2), mesh),
               lambda: replicated(torch.zeros(2), mesh), lambda: check_mesh(mesh)):
        try:
            fn()
        except ValueError as e:
            assert "belong to others" in str(e), e
        else:
            raise AssertionError("a process-spanning mesh placed data")
    others = [p for p in range(n) if p != rank]
    if len(others) >= 2:
        pair = Mesh(np.array(["cuda:0", "cuda:0"], dtype=object), ("data",),
                    processes=others[:2])
        assert not pair.is_local and "process" in repr(pair)
    try:
        Mesh(np.array(["cuda:0", "cuda:0"], dtype=object), ("data",),
             processes=[others[0]] * 2)
    except ValueError as e:
        assert "may appear once" in str(e), e
    else:
        raise AssertionError("one process's cuda:0 was taken twice")
    print(f"rank {rank}: mesh checks OK", flush=True)


def run_case(name: str, dtype: str, out: dict, tmp: str) -> None:
    """One case of ``CASES``: build, query (and add, save, load where the
    case says); every array goes into ``out`` under ``name/dtype/...``."""
    from emr2a_tpu_torch.parallel import default_mesh
    from emr2a_tpu_torch.retrieval.database import ShardedEmbeddingDatabase

    rows, dim, nq, ks, capacity = CASES[name]
    rng = np.random.RandomState(sum(map(ord, name)))     # the same on every rank
    emb = rng.randn(rows, dim).astype(np.float32)
    queries = rng.randn(nq, dim).astype(np.float32)
    key = f"{name}/{dtype}"
    out[f"{key}/emb"], out[f"{key}/queries"] = emb, queries
    meta = {}
    if name in ("search", "add_past_capacity"):
        meta = dict(labels=[f"L{i % 4}" for i in range(rows)],
                    ids=[f"p{i:03d}" for i in range(rows)])
    db = ShardedEmbeddingDatabase(emb, mesh=default_mesh(), dtype=DTYPES[dtype],
                                  capacity=capacity, **meta)
    for k in ks:
        vals, idx = db.topk(queries, k)
        out[f"{key}/k{k}/vals"], out[f"{key}/k{k}/idx"] = vals.numpy(), idx.numpy()
    if name == "add_past_capacity":
        for step, extra_rows in enumerate((3, 10)):         # within, then past capacity
            extra = rng.randn(extra_rows, dim).astype(np.float32)
            out[f"{key}/extra{step}"] = extra
            db.add_cases(extra, labels=["LX"] * extra_rows,
                         ids=[f"x{step}_{i}" for i in range(extra_rows)])
            vals, idx = db.topk(queries, 5)
            out[f"{key}/add{step}/vals"], out[f"{key}/add{step}/idx"] = vals.numpy(), idx.numpy()
        out[f"{key}/capacity"] = np.asarray(db.capacity)
        path = os.path.join(tmp, f"{name}_{dtype}.npz")
        db.save(path)                                        # process 0 writes
        back = ShardedEmbeddingDatabase.load(path, mesh=default_mesh(), dtype=DTYPES[dtype])
        vals, idx = back.topk(queries, 5)
        out[f"{key}/loaded/vals"], out[f"{key}/loaded/idx"] = vals.numpy(), idx.numpy()
        assert back.ids == db.ids and back.n == db.n
    if name == "search":
        hits = db.search(queries, k=3)
        out[f"{key}/search"] = np.asarray(
            [[f"{h['index']}|{h['label']}|{h['patient_id']}" for h in q] for q in hits])
        out[f"{key}/search_scores"] = np.asarray([[h["score"] for h in q] for q in hits])


def cases(rank: int, n: int, out_dir: Path) -> None:
    """The ``--case cases`` run (module docstring)."""
    from emr2a_tpu_torch.parallel import force_cpu_devices

    force_cpu_devices(1)
    mesh_checks(rank, n)
    out = {}
    for name in CASES:
        for dtype in DTYPES:
            run_case(name, dtype, out, str(out_dir))
    np.savez(out_dir / f"rank{rank}.npz", **out)
    print(f"rank {rank}: done", flush=True)


def _quartiles(times) -> list:
    return [float(x) for x in np.percentile(times, [25, 50, 75])]


def search_split(db, query: np.ndarray, k: int, reps: int = 256) -> dict:
    """Each of ``reps`` single-query searches timed alone with CUDA events
    on this rank's card (p50 and quartiles), split into the scan (query
    copy, K6, packing), the all-gather and the merge (medians); and the
    host clock per search, the reps ended by a synchronize."""
    from emr2a_tpu_torch.retrieval.database import (
        all_gather_candidates,
        merge_gathered,
        pack_candidates,
    )

    q = db._queries(query.reshape(1, -1), True)
    k_local = min(k, db.shard_size)
    stream = torch.cuda.current_stream(db.device)
    events = [[torch.cuda.Event(enable_timing=True) for _ in range(4)] for _ in range(reps)]

    def one(ev=None):
        ev and ev[0].record(stream)
        packed = pack_candidates(db._candidates(q, k_local), 1, k_local, len(db.shards),
                                 db.device)
        ev and ev[1].record(stream)
        gathered = all_gather_candidates(packed)
        ev and ev[2].record(stream)
        out = merge_gathered(gathered, db._order, k)
        ev and ev[3].record(stream)
        return out

    one()
    torch.cuda.synchronize(db.device)
    t0 = time.perf_counter()
    for ev in events:
        one(ev)
    torch.cuda.synchronize(db.device)
    host_ms = (time.perf_counter() - t0) / reps * 1e3
    part = lambda a, b: [ev[a].elapsed_time(ev[b]) for ev in events]
    return {"search_ms_quartiles": _quartiles(part(0, 3)),
            "scan_ms": float(np.median(part(0, 1))),
            "all_gather_ms": float(np.median(part(1, 2))),
            "merge_ms": float(np.median(part(2, 3))),
            "host_ms_per_search": host_ms, "reps": reps}


def _k6_counts() -> dict:
    from emr2a_tpu_torch.ops import topk
    return {"cosine_topk_fused": topk.LAUNCHES, "cosine_topk_fused_int8": topk.INT8_LAUNCHES,
            "cosine_topk tile scan": topk.TILE_LAUNCHES}


def _reset_k6() -> None:
    from emr2a_tpu_torch.ops import topk
    topk.LAUNCHES = topk.INT8_LAUNCHES = topk.TILE_LAUNCHES = 0


def measure(device: torch.device, out_dir: Path, timings: bool) -> dict:
    """The ``--case measure`` run (module docstring); returns this rank's
    record."""
    from emr2a_tpu_torch.parallel import process_count, process_index
    from emr2a_tpu_torch.retrieval.database import ShardedEmbeddingDatabase
    from emr2a_tpu_torch.retrieval.database_cli import chained_p50_ms
    from emr2a_tpu_torch.tools.multichip_smoke import _event_ms

    rank = process_index()
    emb = np.load(out_dir / "emb.npy", mmap_mode="c")
    batch = np.load(out_dir / "batch.npy")
    mesh = spanning_mesh(device)
    record = {"rank": rank, "processes": process_count(), "device": str(device),
              "card": torch.cuda.get_device_name(device), "rows": emb.shape[0],
              "dtypes": {}}
    for name, dtype in DTYPES.items():
        t0 = time.time()
        db = ShardedEmbeddingDatabase(emb, mesh=mesh, dtype=dtype, use_pallas=True,
                                      normalize=False)
        torch.cuda.synchronize(device)
        rec = {"build_s": time.time() - t0, "shard_ids": db.shard_ids,
               "shard_size": db.shard_size}
        _reset_k6()
        answers = {}
        for nq, k in CHECKS:
            vals, idx = db.topk(batch[:nq], k)
            answers[f"q{nq}_k{k}_vals"] = vals.cpu().numpy()
            answers[f"q{nq}_k{k}_idx"] = idx.cpu().numpy()
        torch.cuda.synchronize(device)
        rec["launches"] = _k6_counts()
        np.savez(out_dir / f"rank{rank}_{name}.npz", **answers)
        if timings:
            rec["p50_ms"] = chained_p50_ms(db, batch[0], 5, 256)
            rec.update(search_split(db, batch[0], 5))
            qd = db._queries(batch, True)
            rec["q64_ms"] = _event_ms(lambda: db._scan(qd, 5), device)
        record["dtypes"][name] = rec
        if rank == 0:
            print(f"processes {name} rank 0: " + json.dumps(rec), flush=True)
        del db
        torch.cuda.empty_cache()
    (out_dir / f"rank{rank}.json").write_text(json.dumps(record, indent=1))
    return record


def main(argv=None) -> int:
    from emr2a_tpu_torch.parallel import initialize_distributed, shutdown_distributed

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--case", choices=("jax", "cases", "measure"), required=True)
    ap.add_argument("--dir", default=None,
                    help="cases: where the answers go; measure: emb.npy and batch.npy, "
                         "and the answers")
    ap.add_argument("--one_card", action="store_true",
                    help="measure: every rank on cuda:0, the candidates gathered over gloo")
    ap.add_argument("--no_timings", action="store_true")
    args = ap.parse_args(argv)

    rank, n = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    coordinator = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    if args.case != "measure":
        device, backend, ids = torch.device("cpu"), "gloo", None
    elif args.one_card:
        device, backend, ids = torch.device("cuda", 0), "gloo", [0]
    else:
        local = int(os.environ["LOCAL_RANK"])
        device, backend, ids = torch.device("cuda", local), "nccl", [local]
    initialize_distributed(coordinator, n, rank, backend=backend, local_device_ids=ids)
    try:
        if rank == 0:
            nccl = torch.distributed.is_nccl_available()
            version = ".".join(map(str, torch.cuda.nccl.version())) if (
                nccl and torch.cuda.is_available()) else None
            print(f"torch.distributed: backend {backend}, {n} processes; "
                  f"is_nccl_available() {nccl}, NCCL {version}; pid {os.getpid()}", flush=True)
        if args.case == "jax":
            jax_case(device)
        elif args.case == "cases":
            cases(rank, n, Path(args.dir))
        else:
            measure(device, Path(args.dir), not args.no_timings)
    finally:
        shutdown_distributed()
    return 0


if __name__ == "__main__":
    sys.exit(main())
