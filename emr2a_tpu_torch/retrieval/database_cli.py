"""CLI for the one-GPU embedding database.

Port of ``emr2a_tpu/retrieval/database_cli.py``, the user-facing entry to
the 1M-case retrieval path:

    python -m emr2a_tpu_torch.retrieval.database build \\
        --embeddings_path outputs/features/embeddings.npz \\
        --manifest_path outputs/manifest.jsonl --db outputs/db.npz
    python -m emr2a_tpu_torch.retrieval.database query \\
        --db outputs/db.npz --queries_path queries.npz --k 5 \\
        --dtype int8 --output outputs/hits.jsonl
    python -m emr2a_tpu_torch.retrieval.database add \\
        --db outputs/db.npz --embeddings_path new.npz \\
        --manifest_path new_manifest.jsonl

``build``/``add`` read the step2 artifact (``embeddings.npz`` keyed by
patient_id, (n_slices, dim) per patient; a patient is its slice mean) or
the matrix form (``patient_ids`` + ``image_matrix`` or ``embeddings``),
with labels from the step1 manifest. ``query`` loads the database in
``--dtype`` and writes one JSON line per query: {"query_id", "hits":
[{index, score, label, patient_id}]}. ``--dtype int8`` scans a 4x smaller
database with K6's int8 variant.

Differences from the JAX CLI: the commands run on the card, and fail if
there is none, unless ``--cpu`` asks for the CPU; ``query --chained``
times the chained single-query scans with CUDA events and prints the
card's name beside the p50 (on the CPU it refuses: it measures the
device); ``--compile_cache`` is gone (eager PyTorch has no compile step to
cache).
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np

logger = logging.getLogger(__name__)

_DTYPES = ("f32", "bf16", "int8")


def _resolve_dtype(name: str):
    import torch
    return {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}[name]


def _device(args) -> str:
    import torch
    if args.cpu:
        return "cpu"
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the database runs on the card; "
                         "pass --cpu to run it on the CPU")
    return "cuda"


def _load_cases(embeddings_path: Path):
    """npz -> (ids, (n, dim) matrix of per-patient means), from the step2
    layout (one key per patient, (n_slices, dim) each, slice-meaned here) or
    the matrix layout (``patient_ids`` + ``image_matrix`` or
    ``embeddings``; an (n, slices, dim) matrix is slice-meaned)."""
    data = np.load(embeddings_path, allow_pickle=True)
    files = set(data.files)
    if "patient_ids" in files:
        mat_key = next((k for k in ("image_matrix", "embeddings")
                        if k in files), None)
        if mat_key:
            ids = [str(x) for x in data["patient_ids"]]
            emb = np.asarray(data[mat_key], np.float32)
            if emb.ndim == 3:
                emb = emb.mean(axis=1)
            return ids, emb
    means = {}
    for pid in data.files:
        emb = np.asarray(data[pid], np.float32)
        means[pid] = emb.mean(axis=0) if emb.ndim == 2 else emb
    ids = sorted(means)
    return ids, np.stack([means[p] for p in ids])


def _labels_from_manifest(manifest_path: Optional[str]) -> Dict[str, str]:
    if not manifest_path:
        return {}
    from emr2a_tpu_torch.data.manifest import load_manifest
    return {r.get("patient_id"): r.get("label", "unknown")
            for r in load_manifest(manifest_path)}


def cmd_build(args) -> None:
    from emr2a_tpu_torch.retrieval.database import ShardedEmbeddingDatabase

    t0 = time.time()
    ids, emb = _load_cases(Path(args.embeddings_path))
    pid_to_label = _labels_from_manifest(args.manifest_path)
    labels = [pid_to_label.get(p, "unknown") for p in ids]
    t_load = time.time() - t0

    t0 = time.time()
    db = ShardedEmbeddingDatabase(
        emb, labels=labels, ids=ids, dtype=_resolve_dtype(args.dtype),
        capacity=args.capacity, normalize=not args.no_normalize,
        device=_device(args))
    t_ingest = time.time() - t0
    t0 = time.time()
    Path(args.db).parent.mkdir(parents=True, exist_ok=True)
    db.save(args.db)
    t_save = time.time() - t0
    logger.info("Built database: %d cases x %d dims -> %s "
                "(load %.1fs, %s ingest+device %.1fs, save %.1fs)",
                db.n, db.dim, args.db, t_load, args.dtype, t_ingest, t_save)


def cmd_add(args) -> None:
    from emr2a_tpu_torch.retrieval.database import ShardedEmbeddingDatabase

    db = ShardedEmbeddingDatabase.load(
        args.db, dtype=_resolve_dtype(args.dtype), device=_device(args))
    ids, mat = _load_cases(Path(args.embeddings_path))
    pid_to_label = _labels_from_manifest(args.manifest_path)
    present = set(db.ids or [])
    keep = [i for i, p in enumerate(ids) if p not in present]
    new_ids = [ids[i] for i in keep]
    if not new_ids:
        logger.info("No new cases to add (all %d already present)", len(ids))
        return
    db.add_cases(mat[keep],
                 labels=([pid_to_label.get(p, "unknown") for p in new_ids]
                         if db.labels is not None else None),
                 ids=new_ids if db.ids is not None else None,
                 normalize=not args.no_normalize)
    out = args.output or args.db
    db.save(out)
    logger.info("Added %d cases (now %d) -> %s", len(new_ids), db.n, out)


def chained_p50_ms(db, query: np.ndarray, k: int, repeats: int) -> float:
    """Median over 3 runs of the device time per query of ``repeats``
    chained single-query scans, timed with CUDA events (after one
    warm-up run, which builds the kernels)."""
    import torch
    if db.device.type != "cuda":
        raise SystemExit("--chained times the card with CUDA events; it "
                         "needs the card (drop --cpu)")
    db.topk_chained(query, k, repeats=repeats)
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        db.topk_chained(query, k, repeats=repeats)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times)) / repeats


def cmd_query(args) -> None:
    from emr2a_tpu_torch.retrieval.database import ShardedEmbeddingDatabase

    t0 = time.time()
    db = ShardedEmbeddingDatabase.load(
        args.db, dtype=_resolve_dtype(args.dtype), capacity=args.capacity,
        device=_device(args))
    logger.info("Loaded database: %d cases x %d dims (%s) in %.1f s "
                "(disk + device placement)", db.n, db.dim, args.dtype,
                time.time() - t0)
    qids, queries = _load_cases(Path(args.queries_path))

    t0 = time.time()
    results = db.search(queries, k=args.k)
    dt = time.time() - t0
    if args.chained:
        import torch
        reps = max(args.repeat, 2)
        per_q = chained_p50_ms(db, queries[0], args.k, reps)
        logger.info(
            "Chained single-query scan: %.4f ms/query device p50 (median of "
            "3 runs of %d chained scans, CUDA events, one readback; n=%d, "
            "dim=%d, k=%d, %s, use_pallas=%s) on %s",
            per_q, reps, db.n, db.dim, args.k, args.dtype, db.use_pallas,
            torch.cuda.get_device_name(db.device))
    if args.repeat > 1 and not args.chained:
        walls = []
        for _ in range(args.repeat - 1):
            t0 = time.time()
            db.search(queries, k=args.k)
            walls.append(time.time() - t0)
        logger.info(
            "Steady-state search over %d repeats: min %.2f ms, "
            "median %.2f ms (batch of %d queries, host clock, incl host sync)",
            args.repeat - 1, min(walls) * 1e3,
            float(np.median(walls)) * 1e3, len(qids))

    lines = [json.dumps({"query_id": qid, "hits": hits}, ensure_ascii=False)
             for qid, hits in zip(qids, results)]
    if args.output:
        Path(args.output).parent.mkdir(parents=True, exist_ok=True)
        Path(args.output).write_text("\n".join(lines) + "\n", encoding="utf-8")
        logger.info("Wrote %d query results -> %s", len(lines), args.output)
    else:
        for line in lines:
            print(line)
    logger.info("Searched %d queries over %d cases (k=%d, %s) in %.1f ms "
                "(host clock, first call included)",
                len(qids), db.n, args.k, args.dtype, dt * 1e3)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m emr2a_tpu_torch.retrieval.database",
        description="Case-retrieval database on one GPU")
    sub = parser.add_subparsers(dest="command", required=True)

    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--dtype", choices=_DTYPES, default="f32",
                        help="device storage dtype (int8: 4x fewer bytes per "
                             "scan, |cos err| <~ 1/64)")
    common.add_argument("--cpu", action="store_true",
                        help="run on the CPU (default: the card, which must "
                             "be there)")

    b = sub.add_parser("build", parents=[common],
                       help="build a database from a step2 embeddings.npz")
    b.add_argument("--embeddings_path", required=True)
    b.add_argument("--manifest_path", default=None,
                   help="step1 manifest.jsonl for case labels")
    b.add_argument("--db", required=True, help="output database npz path")
    b.add_argument("--capacity", type=int, default=None,
                   help="reserve row capacity for streaming add")
    b.add_argument("--no_normalize", action="store_true")
    b.set_defaults(fn=cmd_build)

    a = sub.add_parser("add", parents=[common],
                       help="append new cases to an existing database")
    a.add_argument("--db", required=True)
    a.add_argument("--embeddings_path", required=True)
    a.add_argument("--manifest_path", default=None)
    a.add_argument("--output", default=None,
                   help="write updated db here (default: overwrite --db)")
    a.add_argument("--no_normalize", action="store_true")
    a.set_defaults(fn=cmd_add)

    q = sub.add_parser("query", parents=[common],
                       help="top-k search against a built database")
    q.add_argument("--db", required=True)
    q.add_argument("--queries_path", required=True,
                   help="npz of query embeddings (same layout as step2)")
    q.add_argument("--k", type=int, default=5)
    q.add_argument("--capacity", type=int, default=None)
    q.add_argument("--repeat", type=int, default=1,
                   help="re-run the search N times and log its steady-state "
                        "host-clock latency")
    q.add_argument("--chained", action="store_true",
                   help="also report the single-query device p50: --repeat "
                        "chained scans of the first query, timed with CUDA "
                        "events (needs the card)")
    q.add_argument("--output", default=None,
                   help="results jsonl path (default: stdout)")
    q.set_defaults(fn=cmd_query)
    return parser


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO,
                        format="%(levelname)s %(name)s: %(message)s",
                        stream=sys.stderr)
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
