"""The port on several cards of one host: the mesh's data and model axes.

    python -m emr2a_tpu_torch.tools.multichip_smoke [--phases a,b,c,d,e,f] [--out FILE]

Needs at least 2 CUDA devices and raises with fewer. Prints every card's
name and power limit (``nvidia-smi``) and the host's cores
(``os.cpu_count()`` and the affinity), then runs the phases; any failure
exits non-zero.

(a) Every kernel on every card: K1 to K9 and K3m at ``chip_smoke.py``'s
    shapes (K1 and K2 with f32 and bf16 activations and quick_gelu, K3, K3m
    and K4 at step2's (32, 200, 768), K2 with quick_gelu and K4 at CLIP
    ViT-L/14-336's width, K5 and K7 at T = 1 (GEMV) and T = 2,048 / 8,192
    (GEMM), K6 at 1M x 512 in f32, bf16 and int8 on its streaming scan (q =
    1) and its tile scan (q = 64, k = 5 and 100), K8 at the judge's (7,
    1024, 16, 72), K9 at ViT-B's (32, 197, 12, 64)), on the same seeded
    inputs on each card, each card's output bit for bit against cuda:0's.
    The phase uses only the wrappers' public functions, so
    ``--phases a --report_only`` runs it against an older tree of the port
    (its package first on ``PYTHONPATH``) and lists the launches that fail
    there instead of failing.
(b) The sharded database: ``--db_rows`` (default 4,194,304 = 1M a card on 4
    cards) x 512 seeded rows over every card against the same rows on
    cuda:0 alone, in f32, bf16 (``use_pallas``: K6) and int8 (K6's int8
    variant): indices equal and values compared bit for bit at q = 1 and q
    = 64 (k = 5 and 100); a database of 5/8 of the rows with the capacity
    of all of them (a short shard and an empty one on 4 cards) against
    cuda:0 alone; K6's launches a search (one a non-empty shard); the
    single-query p50 (``database_cli.chained_p50_ms``: 256 chained searches,
    CUDA events on cuda:0) and the q = 64 search's median device time
    (CUDA events, 20 searches) on one card at 1/n of the rows, one card at
    all of them and every card at all of them; where a search over every
    card spends its time (``merge_breakdown``); then the database CLI
    (build, query, ``query --chained``) on the default mesh over every card,
    hits against one card's.
(c) The data-parallel tower: BioMedCLIP ViT-B/16 at full width (random
    weights, seed 0) in bf16 (K1, K3) and int8 (K2, K4), 128 slices a card
    over every card against one card at 128: the forward's slices/s on
    device-resident pixels (host clock around every card's forward and a
    synchronize of each, median of 20), the host's enqueue of one forward
    (host clock, no synchronize, median of 20) and ``_image_forward``'s from host
    uint8 to host rows (median of 5), in turns; the launches of one
    sharded forward (every block on each card); the rows against one card's
    at the same batch, bit for bit or their least cosine.
(d) step2 end to end with the decode pool (``tools/step2_e2e.measure``,
    ``assume_square_sources``) on ``tools/cohort.py``'s synthetic cohort
    (``--patients`` x ``--slices`` 512x512 grey PNGs), BioMedCLIP bf16, on
    one card and over every card, at step2's batch of 96 and at 96 a card,
    in turns; then step2's CLI (``--encoder_type vit --fast``) with and
    without ``--data_parallel`` on the same cohort, rows compared.
(e) The model axis (needs 4 cards; not in the default phases): K8 at the
    vision tower's per-card shapes (7, 1024, 16 / tp, 72); then
    Qwen3-VL-8B at full width (random bf16 weights, seed 0) on
    ``chip_smoke.py``'s 7-slice audit request (the cohort's step1 manifest
    and a 3-fold CV over seeded embeddings), in bf16, int8 and int4, each
    through ``QwenVLBackend(tp=1)`` (cuda:0), ``tp=2`` (cards 0 and 1 of a
    (2, 2) mesh) and ``tp=4``: greedy tokens against tp = 1's (equal, or
    first different at a near-tie of one card's logits), the last-position
    prefill logits' cosine to one card's (gated by the judge's limits, or
    by a rounding noise-floor control measured on one card where the full
    depth carries rounding noise further), prefill ms and eager decode
    ms/token (CUDA events), parameter and KV bytes and peak GiB by card,
    and K5 / K7 / K8 calls by card (each the kernel's launch: the wrappers'
    counters agree); the continuous batcher over the cohort's 12 fold
    requests at 8 slots, tp = 2 against tp = 1 (cases/s, streams compared);
    the judge's fixed logits limits at 2 + 2 layers, full width, tp = 2 and
    4 in each precision; step4's CLI with ``--tp 2`` against ``--tp 1`` (the
    judge cut to 2 + 2 layers, audit files and each case's stream
    compared); the witness free of bf16's rounding chaos: the 8B at full
    depth and width with f32 weights (random, seed 0), the last-position
    prefill logits at tp = 2 and 4 against one card's, cosine at least
    1 - 1e-5; the contrastive trainer at BioMedCLIP's width, 3 steps at
    meshes (4, 1), (2, 2) and (1, 4) against one card (losses within rtol
    1e-4, ms a step). Every check's failure is collected and the phase
    fails once at its end.
(f) One process a card (not in the default phases): first JAX's
    two-process worker case on the CPU (gloo, ``tools/db_processes.py
    --case jax``); then, in this process, the database of phase b's
    ``--db_rows`` x 512 seeded rows on cuda:0 alone and over every card (one
    process), in f32, bf16 (K6) and int8, its answers at q = 1 (k = 5) and q
    = 64 (k = 5 and 100) and the one-process single-query p50 and q = 64
    search timed as phase b times them; then one process a card
    (``parallel.launch``: ``torchrun``; NCCL, ``local_device_ids=[rank]``:
    ``tools/db_processes.py --case measure``), each building the database
    from the same rows (written once to a file that every rank maps) and
    holding its own shard: every rank's indices equal both
    one-process answers and its values are bit-identical to them, K6
    launched once a search by each rank; each rank's single-query p50 (3
    runs of 256 chained searches), the 256 searches timed alone (quartiles)
    and split into scan, all-gather and merge (CUDA events on each rank's
    card), the host clock per search and the q = 64 search. A failed rank
    fails the phase with every rank's output.

``--out`` writes every record as JSON.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch

DIM = 512
K6_ROWS = 1 << 20


class Failure(RuntimeError):
    pass


def fail(msg: str) -> None:
    raise Failure(msg)


def host_line() -> str:
    cores = len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity") else None
    return f"host: os.cpu_count() {os.cpu_count()}, affinity {cores} cores"


def cards_text() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def sync_all(devices) -> None:
    for d in devices:
        torch.cuda.synchronize(d)


# -- (a) every kernel on every card ------------------------------------------

def _to(obj, dev):
    if isinstance(obj, torch.Tensor):
        return obj.to(dev)
    if isinstance(obj, (tuple, list)):
        return type(obj)(_to(o, dev) for o in obj)
    return obj


def kernel_cases(seed: int = 0) -> list:
    """(name, shape, inputs on the CPU, fn(inputs on one card) -> outputs)."""
    from emr2a_tpu_torch.models.quantize import quantize_weight_int8_torch
    from emr2a_tpu_torch.ops import (attention, attention_block, linear_int4,
                                     linear_int8, mlp, topk, vision_flash)

    g = torch.Generator().manual_seed(seed)

    def rn(*shape, std=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=g) * std).to(dtype)

    def block_weights(d, m):
        ln = ((1.0 + rn(d, std=0.1).float()).to(torch.bfloat16), rn(d, std=0.1))
        mw = (rn(d, m, std=0.02), rn(m, std=0.02), rn(m, d, std=0.02), rn(d, std=0.02))
        aw = [rn(d, d, std=0.02) if i % 2 == 0 else rn(d, std=0.02) for i in range(8)]
        mq, aq = [], []
        for i in (0, 2):
            q, s = quantize_weight_int8_torch(mw[i].float())
            mq += [q, s.reshape(-1), mw[i + 1]]
        for i in (0, 2, 4, 6):
            q, s = quantize_weight_int8_torch(aw[i].float())
            aq += [q, s.reshape(-1), aw[i + 1]]
        return ln, mw, mq, aw, aq

    cases = []
    ln, mw, mq, aw, aq = block_weights(768, 3072)
    x = rn(32, 200, 768)
    x2 = x.reshape(-1, 768)
    for act, tag in ((torch.float32, ""), (torch.bfloat16, " act_dtype=bf16")):
        cases.append((f"fused_ln_mlp{tag}", "T=6400, 768->3072->768", (x2, ln, mw),
                      lambda a, act=act: mlp.fused_ln_mlp(a[0], *a[1], *a[2], act_dtype=act)))
        cases.append((f"fused_ln_mlp_int8{tag}", "T=6400, 768->3072->768", (x2, ln, mq),
                      lambda a, act=act: mlp.fused_ln_mlp_int8(a[0], *a[1], *a[2],
                                                               act_dtype=act)))
    cases.append(("fused_ln_mlp activation=quick_gelu", "T=6400, 768->3072->768",
                  (x2, ln, mw), lambda a: mlp.fused_ln_mlp(a[0], *a[1], *a[2],
                                                           activation="quick_gelu")))
    cases.append(("fused_ln_attention", "(32, 200, 768), valid_len 197", (x, ln, aw),
                  lambda a: attention_block.fused_ln_attention(
                      a[0], *a[1], *a[2], num_heads=12, valid_len=197)))
    cases.append(("fused_ln_attention_merged", "(32, 200, 768), valid_len 197, block_b 4",
                  (x, ln, aw), lambda a: attention_block.fused_ln_attention(
                      a[0], *a[1], *a[2], num_heads=12, valid_len=197, block_b=4,
                      merge_batch=True)))
    cases.append(("fused_ln_attention_int8", "(32, 200, 768), valid_len 197", (x, ln, aq),
                  lambda a: attention_block.fused_ln_attention_int8(
                      a[0], *a[1], *a[2], num_heads=12, valid_len=197)))
    ln_l, _, mq_l, _, aq_l = block_weights(1024, 4096)
    xl = rn(8, 584, 1024)
    cases.append(("fused_ln_mlp_int8 activation=quick_gelu", "T=4672, 1024->4096->1024",
                  (xl.reshape(-1, 1024), ln_l, mq_l),
                  lambda a: mlp.fused_ln_mlp_int8(a[0], *a[1], *a[2],
                                                  activation="quick_gelu")))
    cases.append(("fused_ln_attention_int8", "(8, 584, 1024), 16 heads, valid_len 577",
                  (xl, ln_l, aq_l), lambda a: attention_block.fused_ln_attention_int8(
                      a[0], *a[1], *a[2], num_heads=16, valid_len=577)))
    for T, K, N in ((8192, 768, 3072), (1, 4096, 12288), (2048, 4096, 12288)):
        w = rn(K, N, std=0.02).float()
        q8, s8 = quantize_weight_int8_torch(w)
        p4, s4 = linear_int4.quantize_weight_int4_torch(w)
        xin, bias = rn(T, K), rn(N, std=0.02)
        cases.append(("linear_w8a8", f"T={T}, {K}->{N}", (xin, q8, s8.reshape(-1), bias),
                      lambda a: linear_int8.linear_w8a8(*a)))
        if K == 4096:
            cases.append(("linear_w4a8", f"T={T}, {K}->{N}", (xin, p4, s4, bias),
                          lambda a: linear_int4.linear_w4a8(*a)))
    unit = torch.nn.functional.normalize(torch.randn(K6_ROWS, DIM, generator=g), dim=-1)
    queries = torch.nn.functional.normalize(torch.randn(64, DIM, generator=g), dim=-1)
    amax = unit.abs().amax(dim=1)
    scales = amax / torch.full_like(amax, 127.0)
    scales = torch.where(scales == 0, torch.ones_like(scales), scales)
    codes = torch.clamp(torch.round(unit / scales[:, None]), -127, 127).to(torch.int8)
    for nq, k in ((1, 5), (64, 5), (64, 100)):
        shape = f"1M x 512, q={nq}, k={k}"
        for store, db in (("f32", unit), ("bf16", unit.to(torch.bfloat16))):
            cases.append((f"cosine_topk_fused {store}", shape, (queries[:nq], db),
                          lambda a, k=k: topk.cosine_topk_fused(a[0], a[1], k)))
        cases.append(("cosine_topk_fused_int8", shape, (queries[:nq], codes, scales),
                      lambda a, k=k: topk.cosine_topk_fused_int8(a[0], a[1], a[2], k)))
    qkv = tuple(rn(7, 1024, 16, 72) for _ in range(3))
    cases.append(("frame_flash_attention", "(7, 1024, 16, 72)", qkv,
                  lambda a: vision_flash.frame_flash_attention(*a, 72 ** -0.5)))
    qkv9 = tuple(rn(32, 197, 12, 64) for _ in range(3))
    cases.append(("fused_attention", "(32, 197, 12, 64)", qkv9,
                  lambda a: attention.fused_attention(*a)))
    return cases


def kernels_on_every_card(devices, report_only: bool) -> list:
    """Each case on cuda:0, then on every other card, on the same inputs;
    each card's outputs bit for bit against cuda:0's. Returns one record a
    case; with ``report_only`` a failed launch or a difference is recorded,
    not raised."""
    records = []
    for name, shape, inputs, fn in kernel_cases():
        rec = {"kernel": name, "shape": shape, "cards": {}}
        want = None
        for dev in devices:
            try:
                with torch.cuda.device(dev):
                    out = fn(_to(inputs, dev))
                out = out if isinstance(out, tuple) else (out,)
                torch.cuda.synchronize(dev)
                out = tuple(o.cpu() for o in out)
                if want is None:
                    want, verdict = out, "reference"
                else:
                    same = all(torch.equal(a, b) for a, b in zip(out, want))
                    verdict = "bit-identical to cuda:0" if same else "differs from cuda:0"
            except (RuntimeError, ValueError) as e:
                verdict = f"failed: {str(e).splitlines()[0][:160]}"
            rec["cards"][str(dev)] = verdict
            if verdict.startswith(("failed", "differs")) and not report_only:
                fail(f"{name} {shape} on {dev}: {verdict}")
        print(f"kernel {name} {shape}: " + "; ".join(f"{d} {v}" for d, v in
                                                   rec["cards"].items()), flush=True)
        records.append(rec)
        del inputs
    failed = [f"{r['kernel']} {r['shape']} on {d}" for r in records
              for d, v in r["cards"].items() if not v.startswith(("reference", "bit-"))]
    print(f"phase a: {len(records)} kernel cases on {len(devices)} cards; "
          f"{len(failed)} failed or differ" + (": " + "; ".join(failed) if failed else ""),
          flush=True)
    return records


# -- (b) the sharded database ------------------------------------------------

def _event_ms(fn, device, iters: int = 20) -> float:
    """Median device ms of ``fn`` over ``iters`` calls, CUDA events on
    ``device``'s current stream (after one warm-up)."""
    fn()
    torch.cuda.synchronize(device)
    stream = torch.cuda.current_stream(device)
    times = []
    for _ in range(iters):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record(stream)
        fn()
        end.record(stream)
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _same(tag: str, got, want, records: dict) -> None:
    """Indices equal (else fail); values bit for bit (recorded)."""
    if not torch.equal(got[1].cpu(), want[1].cpu()):
        fail(f"{tag}: indices differ from one card's")
    bits = torch.equal(got[0].cpu(), want[0].cpu())
    err = (got[0].cpu() - want[0].cpu()).abs().max().item()
    records[tag] = {"indices_equal": True, "values_bit_identical": bits, "max_abs_err": err}
    print(f"{tag}: indices equal to one card's; values "
          + ("bit-identical" if bits else f"differ by at most {err:.3g}"), flush=True)


def merge_breakdown(db, query: np.ndarray, devices, reps: int = 256) -> dict:
    """Where a single-query search over every card spends its time: the
    host's enqueue of ``reps`` searches (no synchronize inside), the shards'
    scans alone (queries already on each card, no copies and no merge) and
    the copies alone (the query to each card, the candidates back), each
    per search on the host clock over ``reps`` searches ended by a
    synchronize of every card; whether each card reaches cuda:0 by peer
    access; and ``torch.profiler``'s device ms per search by kernel or
    copy, over 20 searches."""
    from torch.profiler import ProfilerActivity, profile

    from emr2a_tpu_torch.retrieval.database import shard_topk

    q = db._queries(query.reshape(1, -1), True)
    per_card = [q.to(d) for d in db.devices]
    k_local = min(5, db.shard_size)

    def scans():
        for i, (qc, shard) in enumerate(zip(per_card, db.shards)):
            shard_topk(qc, shard, None if db.scale_shards is None else db.scale_shards[i],
                       min(max(db.n - i * db.shard_size, 0), db.shard_size),
                       i * db.shard_size, k_local, db.use_pallas)

    cand = [(torch.zeros(1, 5, device=d), torch.zeros(1, 5, dtype=torch.int32, device=d))
            for d in db.devices]

    def copies():
        for d in db.devices:
            q.to(d, non_blocking=True)
        for v, i in cand:
            v.to(db.device, non_blocking=True)
            i.to(db.device, non_blocking=True)

    def per_search(fn):
        fn()
        sync_all(devices)
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        enqueued = time.perf_counter() - t0
        sync_all(devices)
        return (time.perf_counter() - t0) / reps * 1e3, enqueued / reps * 1e3

    search_ms, enqueue_ms = per_search(lambda: db._scan(q, 5))
    out = {"peer_access_from_cuda0": [torch.cuda.can_device_access_peer(0, d.index)
                                      for d in devices[1:]],
           "search_ms": search_ms, "host_enqueue_ms": enqueue_ms,
           "scans_only_ms": per_search(scans)[0], "copies_only_ms": per_search(copies)[0]}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            db._scan(q, 5)
        sync_all(devices)
    dev_ms = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        us = e.cuda_time_total if us is None else us
        if us > 0:
            name = e.key.split("(")[0].replace("void ", "")[:60]
            dev_ms[name] = dev_ms.get(name, 0.0) + us / 1e3 / 20
    out["device_ms_per_search"] = dict(sorted(dev_ms.items(), key=lambda kv: -kv[1])[:8])
    return out


def database_phase(devices, rows: int, cli_rows: int) -> dict:
    from emr2a_tpu_torch.ops import topk
    from emr2a_tpu_torch.parallel import create_mesh
    from emr2a_tpu_torch.retrieval import database_cli
    from emr2a_tpu_torch.retrieval.database import ShardedEmbeddingDatabase

    n_cards = len(devices)
    rng = np.random.default_rng(0)
    t0 = time.time()
    emb = rng.standard_normal((rows, DIM), dtype=np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True) + 1e-12
    picks = rng.choice(rows, 64, replace=False)
    batch = emb[picks] + 0.1 * rng.standard_normal((64, DIM), dtype=np.float32)
    print(f"database: {rows} x {DIM} seeded rows in {time.time() - t0:.1f} s", flush=True)
    every = create_mesh((n_cards, 1), devices=devices)
    one = create_mesh((1, 1), devices=devices[:1])
    out = {"rows": rows, "cards": n_cards, "checks": {}, "p50_ms": {}, "q64_ms": {},
           "launches_per_search": {}}
    short_rows = rows * 5 // 8
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16),
                        ("int8", torch.int8)):
        kw = dict(dtype=dtype, use_pallas=True, normalize=False)
        t0 = time.time()
        dbs = {f"1 card, {rows // n_cards} rows": ShardedEmbeddingDatabase(
                   emb[:rows // n_cards], mesh=one, **kw),
               f"1 card, {rows} rows": ShardedEmbeddingDatabase(emb, mesh=one, **kw),
               f"{n_cards} cards, {rows} rows": ShardedEmbeddingDatabase(emb, mesh=every, **kw)}
        sync_all(devices)
        print(f"database {name}: built in {time.time() - t0:.1f} s", flush=True)
        whole, sharded = dbs[f"1 card, {rows} rows"], dbs[f"{n_cards} cards, {rows} rows"]
        for nq, k in ((1, 5), (64, 5), (64, 100)):
            _same(f"database {name} q={nq} k={k}, {n_cards} cards vs 1",
                  sharded.topk(batch[:nq], k), whole.topk(batch[:nq], k), out["checks"])
        q = sharded._queries(batch, True)
        counter = "cosine_topk_fused_int8" if name == "int8" else "cosine_topk_fused"
        before = getattr(topk, "INT8_LAUNCHES" if name == "int8" else "LAUNCHES")
        sharded._scan(q, 5)
        sync_all(devices)
        launched = getattr(topk, "INT8_LAUNCHES" if name == "int8" else "LAUNCHES") - before
        if launched != n_cards:
            fail(f"database {name}: {counter} launched {launched} times a search, "
                 f"expected {n_cards} (one a shard)")
        out["launches_per_search"][name] = launched
        br = merge_breakdown(sharded, batch[0], devices)
        out.setdefault("merge_breakdown", {})[name] = br
        print(f"database {name}, {n_cards} cards, q=1 search: {br['search_ms']:.4f} ms on the "
              f"host clock, host enqueue {br['host_enqueue_ms']:.4f}, the shards' scans alone "
              f"{br['scans_only_ms']:.4f}, the copies alone {br['copies_only_ms']:.4f} (per "
              f"search, 256 searches); peer access from cuda:0 {br['peer_access_from_cuda0']}; "
              f"device ms a search by op: " + ", ".join(
                  f"{k} {v:.4f}" for k, v in br["device_ms_per_search"].items()), flush=True)
        for tag, db in dbs.items():
            p50 = database_cli.chained_p50_ms(db, batch[0], 5, 256)
            qd = db._queries(batch, True)
            q64 = _event_ms(lambda: db._scan(qd, 5), devices[0])
            out["p50_ms"][f"{name}, {tag}"] = p50
            out["q64_ms"][f"{name}, {tag}"] = q64
            print(f"database p50 {name}, {tag}: {p50:.4f} ms/query (median of 3 runs of "
                  f"256 chained searches, CUDA events on {devices[0]}); q=64, k=5 search "
                  f"{q64:.4f} ms (median of 20, CUDA events)", flush=True)
        del dbs, whole, sharded
        torch.cuda.empty_cache()
        if name in ("f32", "int8"):
            short = ShardedEmbeddingDatabase(emb[:short_rows], mesh=every, capacity=rows, **kw)
            shards = [min(max(short.n - i * short.shard_size, 0), short.shard_size)
                      for i in range(n_cards)]
            ref = ShardedEmbeddingDatabase(emb[:short_rows], mesh=one, **kw)
            for nq, k in ((1, 5), (64, 100)):
                _same(f"database {name} {short_rows} rows (valid rows a shard {shards}) "
                      f"q={nq} k={k}", short.topk(batch[:nq], k), ref.topk(batch[:nq], k),
                      out["checks"])
            del short, ref
            torch.cuda.empty_cache()

    # the CLI on the default mesh (every card) against one card
    with tempfile.TemporaryDirectory(prefix="multichip_db_") as tmp:
        tmp = Path(tmp)
        ids = np.asarray([f"c{i:07d}" for i in range(cli_rows)])
        np.savez(tmp / "cases.npz", patient_ids=ids, embeddings=emb[:cli_rows])
        np.savez(tmp / "queries.npz", patient_ids=ids[:64], embeddings=emb[:64])
        t0 = time.time()
        database_cli.main(["build", "--embeddings_path", str(tmp / "cases.npz"),
                           "--db", str(tmp / "db.npz"), "--dtype", "int8"])
        database_cli.main(["query", "--db", str(tmp / "db.npz"), "--queries_path",
                           str(tmp / "queries.npz"), "--k", "5", "--dtype", "int8",
                           "--output", str(tmp / "hits.jsonl"), "--chained",
                           "--repeat", "256"])
        hits = [json.loads(l) for l in (tmp / "hits.jsonl").read_text().splitlines()]
        ref = ShardedEmbeddingDatabase.load(tmp / "db.npz", dtype=torch.int8,
                                            device=str(devices[0]))
        want = ref.search(emb[:64], 5)
        if [h["hits"] for h in hits] != want:
            fail("database CLI on the default mesh: hits differ from one card's")
        if any(h["hits"][0]["patient_id"] != h["query_id"] for h in hits):
            fail("database CLI: a case did not retrieve itself first")
        print(f"database CLI build + query --chained on the default mesh ({n_cards} cards), "
              f"{cli_rows} x {DIM} int8: 64 queries' hits equal one card's "
              f"({time.time() - t0:.1f} s with the npz writes)", flush=True)
    return out


# -- (c) the data-parallel tower -------------------------------------------------

def _launches() -> dict:
    from emr2a_tpu_torch.ops import attention_block, mlp
    return {"fused_ln_mlp": mlp.LAUNCHES, "fused_ln_attention": attention_block.LAUNCHES,
            "fused_ln_mlp_int8": mlp.INT8_LAUNCHES,
            "fused_ln_attention_int8": attention_block.INT8_LAUNCHES}


def tower_phase(devices, per_card: int) -> dict:
    from emr2a_tpu_torch.encoders.biomedclip_encoder import BioMedCLIPEncoder
    from emr2a_tpu_torch.ops.preprocess import preprocess_images
    from emr2a_tpu_torch.parallel import create_mesh

    n_cards = len(devices)
    every = create_mesh((n_cards, 1), devices=devices)
    rng = np.random.default_rng(2)
    u8 = rng.integers(0, 256, (per_card * n_cards, 224, 224, 3), dtype=np.uint8)
    out = {}
    for prec, fast, kernels in (("bf16", True, ("fused_ln_mlp", "fused_ln_attention")),
                                ("int8", "int8", ("fused_ln_mlp_int8",
                                                  "fused_ln_attention_int8"))):
        enc_all = BioMedCLIPEncoder.random_init(seed=0, fast=fast, mesh=every,
                                                max_batch=per_card * n_cards)
        enc_one = BioMedCLIPEncoder.random_init(seed=0, fast=fast, device=str(devices[0]),
                                                max_batch=per_card * n_cards)
        before = _launches()
        rows_all = enc_all._image_forward(u8)
        after = _launches()
        for name in kernels:
            if after[name] - before[name] != 12 * n_cards:
                fail(f"tower {prec}: {name} launched {after[name] - before[name]} times in "
                     f"one sharded forward, expected {12 * n_cards}")
        rows_one = enc_one._image_forward(u8)
        rows_chunks = np.concatenate([enc_one._image_forward(u8[i * per_card:(i + 1) * per_card])
                                      for i in range(n_cards)])
        cos = lambda a, b: float(((a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                                                     * np.linalg.norm(b, axis=-1))).min())
        rec = {"bit_identical_to_one_card_same_batch": bool(np.array_equal(rows_all, rows_one)),
               "bit_identical_to_one_card_per_card_batches":
                   bool(np.array_equal(rows_all, rows_chunks)),
               "min_cosine_to_one_card": cos(rows_all, rows_one)}
        if rec["min_cosine_to_one_card"] < 0.999:
            fail(f"tower {prec}: {n_cards} cards' rows against one card's: cosine "
                 f"{rec['min_cosine_to_one_card']}")
        print(f"tower {prec}: {n_cards} x {per_card} rows against one card at "
              f"{per_card * n_cards}: bit-identical {rec['bit_identical_to_one_card_same_batch']}, "
              f"against one card in batches of {per_card}: bit-identical "
              f"{rec['bit_identical_to_one_card_per_card_batches']}; min cosine "
              f"{rec['min_cosine_to_one_card']:.7f}", flush=True)
        with torch.inference_mode():
            pix = [preprocess_images(torch.from_numpy(u8[i * per_card:(i + 1) * per_card]).to(d),
                                     enc_all.preprocess) for i, d in enumerate(devices)]

            def forward_all():
                for model, p in zip(enc_all._image_models, pix):
                    model(p)
                sync_all(devices)

            def forward_one():
                enc_one.image_model(pix[0])
                torch.cuda.synchronize(devices[0])

            def host_ms(fn, iters):
                fn()
                ts = []
                for _ in range(iters):
                    t0 = time.perf_counter()
                    fn()
                    ts.append((time.perf_counter() - t0) * 1e3)
                return float(np.median(ts))

            times = {"one": [], "all": []}
            for turn in ("one", "all", "all", "one"):
                times[turn].append(host_ms(forward_one if turn == "one" else forward_all, 20))
            enqueue = []
            for _ in range(20):
                torch.cuda.synchronize(devices[0])
                t0 = time.perf_counter()
                enc_one.image_model(pix[0])
                enqueue.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize(devices[0])
        e2e = {"one": [], "all": []}
        for turn in ("one", "all", "all", "one"):
            e2e[turn].append(host_ms(
                (lambda: enc_one._image_forward(u8[:per_card])) if turn == "one"
                else (lambda: enc_all._image_forward(u8)), 5))
        rec.update({
            "forward_ms_one_card": times["one"], "forward_ms_all_cards": times["all"],
            "host_enqueue_ms_one_forward": float(np.median(enqueue)),
            "slices_per_s_one_card": per_card / min(times["one"]) * 1e3,
            "slices_per_s_all_cards": per_card * n_cards / min(times["all"]) * 1e3,
            "image_forward_ms_one_card": e2e["one"], "image_forward_ms_all_cards": e2e["all"],
            "image_forward_slices_per_s_one_card": per_card / min(e2e["one"]) * 1e3,
            "image_forward_slices_per_s_all_cards": per_card * n_cards / min(e2e["all"]) * 1e3})
        print(f"tower {prec}: forward on device-resident pixels {rec['slices_per_s_all_cards']:.1f} "
              f"slices/s on {n_cards} cards x {per_card} against {rec['slices_per_s_one_card']:.1f} "
              f"on one card at {per_card} (medians of 20, host clock, turns one/all/all/one: "
              f"{times['one'][0]:.3f}/{times['all'][0]:.3f}/{times['all'][1]:.3f}/"
              f"{times['one'][1]:.3f} ms; the host enqueues one forward in "
              f"{rec['host_enqueue_ms_one_forward']:.3f} ms); _image_forward host u8 -> host rows "
              f"{rec['image_forward_slices_per_s_all_cards']:.1f} against "
              f"{rec['image_forward_slices_per_s_one_card']:.1f} (medians of 5)", flush=True)
        out[prec] = rec
        del enc_all, enc_one, pix
        torch.cuda.empty_cache()
    return out


# -- (d) step2 end to end ------------------------------------------------------------

def step2_phase(devices, patients: int, slices: int, batch: int) -> dict:
    from emr2a_tpu_torch.data.manifest import load_manifest
    from emr2a_tpu_torch.encoders.biomedclip_encoder import BioMedCLIPEncoder
    from emr2a_tpu_torch.parallel import create_mesh
    from emr2a_tpu_torch.pipelines.step2_embeddings import build_embeddings as step2
    from emr2a_tpu_torch.tools.cohort import write_cohort
    from emr2a_tpu_torch.tools.step2_e2e import measure

    n_cards = len(devices)
    every = create_mesh((n_cards, 1), devices=devices)
    out = {"runs": {}}
    with tempfile.TemporaryDirectory(prefix="multichip_step2_") as tmp:
        root = Path(tmp)
        t0 = time.time()
        mpath = write_cohort(root, n_patients=patients, n_slices=slices)
        print(f"step2: cohort of {patients} x {slices} 512^2 PNGs in "
              f"{time.time() - t0:.1f} s", flush=True)
        paths = {r["patient_id"]: r["slices"] for r in load_manifest(mpath)}
        encoders = {
            f"1 card, batch {batch}": (BioMedCLIPEncoder.random_init(
                seed=0, fast=True, device=str(devices[0]), max_batch=batch), batch),
            f"{n_cards} cards, batch {batch}": (BioMedCLIPEncoder.random_init(
                seed=0, fast=True, mesh=every, max_batch=batch), batch),
            f"{n_cards} cards, batch {batch * n_cards}": (BioMedCLIPEncoder.random_init(
                seed=0, fast=True, mesh=every, max_batch=batch * n_cards), batch * n_cards)}
        order = list(encoders) + list(encoders)[::-1]
        rows = {}
        for i, tag in enumerate(order):
            enc, bs = encoders[tag]
            res = measure(enc, paths, root / f"out{i}", bs)
            sync_all(devices)
            out["runs"].setdefault(tag, []).append(res)
            rows.setdefault(tag, dict(np.load(root / f"out{i}" / "embeddings.npz")))
            print(f"step2 e2e {tag}: {res['end_to_end_slices_per_s']:.1f} slices/s end to end, "
                  f"embed {res['embed_slices_per_s']:.1f} ({res['pool_batches']} pool batches)",
                  flush=True)
        ref = rows[order[0]]
        for tag, r in rows.items():
            same = all(np.array_equal(r[p], ref[p]) for p in ref)
            out.setdefault("bit_identical_to_one_card", {})[tag] = same
            if not same:
                worst = min(float(((r[p] * ref[p]).sum(-1)).min()) for p in ref)
                if worst < 0.999:
                    fail(f"step2 {tag}: rows against one card's: cosine {worst}")
                print(f"step2 {tag}: rows not bit-identical to one card's, min cosine "
                      f"{worst:.7f}", flush=True)
        del encoders
        torch.cuda.empty_cache()
        cli = {}
        for tag, extra in (("vit --fast", []), ("vit --fast --data_parallel",
                                                ["--data_parallel"])):
            t0 = time.time()
            step2.main(["--manifest_path", str(mpath), "--output_dir", str(root / tag),
                        "--encoder_type", "vit", "--fast", "--batch_size", str(batch),
                        "--device", "cuda", *extra])
            cli[tag] = time.time() - t0
        a, b = (np.load(root / t / "embeddings.npz") for t in cli)
        same = all(np.array_equal(a[p], b[p]) for p in a.files)
        out["cli_seconds"] = cli
        out["cli_bit_identical"] = same
        print(f"step2 CLI on {patients} x {slices} slices: {cli['vit --fast']:.1f} s on one "
              f"card, {cli['vit --fast --data_parallel']:.1f} s with --data_parallel over "
              f"{n_cards} cards (encoder build included); rows bit-identical {same}",
              flush=True)
    return out


# -- (e) the model axis --------------------------------------------------------

TP_SIZES = (1, 2, 4)
TP_PRECISIONS = ("bf16", "int8", "int4")
TP_TOKENS = 32                 # greedy tokens compared a precision and tp
TP_DECODE_STEPS = 8            # eager decode steps timed
# the judge's gates (chip_smoke.py): last-position logits cosine to one
# card, and the largest logit gap a greedy stream may flip at
TP_COSINE = {"bf16": 0.9998, "int8": 0.997, "int4": 0.997}
TP_NEAR_TIE = {"bf16": 0.2, "int8": 0.75, "int4": 0.75}
TP_SLOTS = 8
TP_STEP4_CASES, TP_STEP4_TOKENS = 4, 16
TP_F32_COSINE = 1 - 1e-5      # the f32 witness: f32 rounding alone stays far above
TP_TRAIN_MESHES = ((4, 1), (2, 2), (1, 4))
TP_TRAIN_BATCH, TP_TRAIN_LR, TP_TRAIN_STEPS = 32, 1e-4, 3


class _Gates:
    """Phase e's failed checks, collected so that one run measures every
    part; ``tp_phase`` fails with all of them at the end."""

    def __init__(self):
        self.failed = []

    @contextmanager
    def check(self, what: str):
        try:
            yield
        except Failure as e:
            self.failed.append(f"{what}: {e}")
            print(f"FAIL (phase e, {what}): {e}", file=sys.stderr, flush=True)


class _Launches:
    """The K5 / K7 / K8 wrappers' calls on CUDA tensors by card, counted
    while open (the models' own references to the wrappers are replaced),
    and the wrappers' own launch counters over the same window."""

    def __enter__(self):
        from emr2a_tpu_torch.models import layers, qwen3_vl
        from emr2a_tpu_torch.ops import linear_int4, linear_int8, vision_flash
        self.counts = {}
        self.sites = [(qwen3_vl, "frame_flash_attention", vision_flash),
                      (layers, "linear_w8a8", linear_int8), (layers, "linear_w4a8", linear_int4)]
        self.before = [op.LAUNCHES for _, _, op in self.sites]
        self.originals = [getattr(m, name) for m, name, _ in self.sites]

        def counted(name, fn):
            def call(x, *a, **kw):
                if x.device.type == "cuda":
                    key = (name, x.device.index)
                    self.counts[key] = self.counts.get(key, 0) + 1
                return fn(x, *a, **kw)
            return call

        for (m, name, _), fn in zip(self.sites, self.originals):
            setattr(m, name, counted(name, fn))
        return self

    def __exit__(self, *exc):
        for (m, name, _), fn in zip(self.sites, self.originals):
            setattr(m, name, fn)
        self.launched = {name: op.LAUNCHES - b
                         for (_, name, op), b in zip(self.sites, self.before)}

    def by_card(self) -> dict:
        out = {}
        for (name, card), n in sorted(self.counts.items()):
            out.setdefault(name, {})[card] = n
        return out


def _bytes_by_card(tensors) -> dict:
    """The bytes the tensors keep resident, by card: each distinct storage
    counted whole, once (a view keeps all of its storage)."""
    seen, out = set(), {}
    for t in tensors:
        if t.device.type != "cuda":
            continue
        storage = t.untyped_storage()
        key = (t.device.index, storage.data_ptr())
        if key in seen:
            continue
        seen.add(key)
        out[t.device.index] = out.get(t.device.index, 0) + storage.nbytes()
    return out


def _model_tensors(model) -> list:
    from emr2a_tpu_torch.models.qwen3_vl import ShardedQwen3VLModel
    parts = (list(model.language_model.shards) + list(model.visual.shards)
             if isinstance(model, ShardedQwen3VLModel) else [model])
    return [t for m in parts for t in m.state_dict().values()]


def _forced_logits(backend, prepared: tuple, prefix) -> torch.Tensor:
    """The f32 logits that choose the token after ``prefix`` (generated
    tokens) of a greedy stream of the prompt ``prepared`` (``_prepare``'s
    ids, patches and grids), by one prefill of the prompt and the prefix on
    ``backend``'s generator."""
    from emr2a_tpu_torch.models.qwen3_vl import compute_mrope_position_ids
    gen = backend.generator
    ids, patches, grids = prepared
    ids = np.asarray([list(ids) + [int(t) for t in prefix]])
    pos = compute_mrope_position_ids(ids, grids, backend.config.image_token_id,
                                     backend.config.vision.spatial_merge_size)
    with torch.inference_mode():
        inputs = gen.device_inputs(ids, patches, tuple(grids), backend.prompt_bucket,
                                   position_ids=pos)
        _, last, _ = gen._prefill(*inputs[:4], tuple(grids), inputs[4], inputs[4] + 1)
    return last[0].float()


def _near_tie(tag: str, base, prepared: tuple, got, want, limit: float):
    """``got`` against ``want`` (greedy rows of the prompt ``prepared``):
    equal, or at their first difference k the two tokens' logits on
    ``base`` (one card, the prompt and want[:k]) within ``limit`` of each
    other. Returns (k, gap) or None."""
    got, want = np.asarray(got), np.asarray(want)
    diff = np.nonzero(got != want)[0]
    if not len(diff):
        return None
    k = int(diff[0])
    lg = _forced_logits(base, prepared, want[:k])
    gap = abs(float(lg[int(want[k])] - lg[int(got[k])]))
    if gap > limit:
        fail(f"{tag}: differs from one card at token {k} ({int(got[k])} against "
             f"{int(want[k])}), logit gap {gap:.4f} over the near-tie limit {limit}")
    return k, round(gap, 4)


def _judge_run(tag: str, backend, request: dict, devices, prec: str) -> dict:
    """One request on ``backend``: greedy tokens (``generate``), the
    last-position prefill logits, prefill ms and eager decode ms/token (CUDA
    events on the first card, which the all-reduces join), bytes and peak
    memory by card, and the K5 / K7 / K8 calls by card of one prefill and
    the timed decode steps."""
    from emr2a_tpu_torch.models.qwen3_vl import cache_tensors
    gen, model = backend.generator, backend.model
    ids, patches, grids = backend._prepare(request["images"], request["prompt"],
                                           request["system"])
    grids = tuple(grids)
    for d in devices:
        torch.cuda.synchronize(d)
        torch.cuda.reset_peak_memory_stats(d)
    t0 = time.time()
    tokens = gen.generate(np.asarray([ids]), pixel_patches=patches, grid_thw=grids,
                          max_new_tokens=TP_TOKENS, prompt_bucket=backend.prompt_bucket)[0]
    sync_all(devices)
    wall = time.time() - t0
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    forwards = {"text": 0, "vision": 0}

    def seen(kind):
        def hook(module, args):
            forwards[kind] += 1
        return hook

    hooks = [model.language_model.register_forward_pre_hook(seen("text")),
             model.visual.register_forward_pre_hook(seen("vision"))]
    with torch.inference_mode(), _Launches() as launches:
        inputs = gen.device_inputs(np.asarray([ids]), patches, grids, backend.prompt_bucket)
        padded = inputs[4]
        sync_all(devices)
        ev[0].record()
        _, last, _ = gen._prefill(*inputs[:4], grids, padded, padded + TP_DECODE_STEPS + 1)
        ev[1].record()
        ev[1].synchronize()
        state = gen.start(np.asarray([ids]), patches, grids, TP_DECODE_STEPS + 1,
                          prompt_bucket=backend.prompt_bucket)
        sync_all(devices)
        ev[2].record()
        for _ in range(TP_DECODE_STEPS):
            gen.decode_step(state)
        ev[3].record()
        ev[3].synchronize()
    for hook in hooks:
        hook.remove()
    sync_all(devices)
    out = {"tokens": tokens.tolist(), "logits": last[0].float(), "wall_s": wall,
           "prompt_tokens": len(ids), "padded": padded,
           "prefill_ms": ev[0].elapsed_time(ev[1]),
           "decode_ms_per_token": ev[2].elapsed_time(ev[3]) / TP_DECODE_STEPS,
           "param_bytes": _bytes_by_card(_model_tensors(model)),
           "kv_bytes": _bytes_by_card(cache_tensors(state.cache)),
           "peak_gib": {d.index: torch.cuda.max_memory_allocated(d) / 2**30 for d in devices},
           "launches_by_card": launches.by_card(), "launches": launches.launched}
    out["forwards"] = forwards
    out["cards"] = [d.index for d in getattr(model, "devices", [gen.device])]
    return out


def _noise_floor(backend, request: dict, devices) -> float:
    """The logits cosine that rounding alone costs on one card: the
    last-position prefill logits with one bf16 ulp added to 16 seeded
    elements of the decoder's input embeddings, against the same prefill
    unperturbed (a random-weight model carries such a perturbation through
    36 layers; the model axis rounds its row-parallel sums differently from
    one card)."""
    gen, lm = backend.generator, backend.model.language_model
    ids, patches, grids = backend._prepare(request["images"], request["prompt"],
                                           request["system"])
    picked = torch.randperm(len(ids) * backend.config.text.hidden_size,
                            generator=torch.Generator().manual_seed(1))[:16]

    def nudge(module, args, kwargs):
        e = args[0].clone()
        e.view(-1).view(torch.int16)[picked.to(e.device)] += 1
        return (e,) + args[1:], kwargs

    logits = []
    for perturb in (False, True):
        hook = lm.register_forward_pre_hook(nudge, with_kwargs=True) if perturb else None
        with torch.inference_mode():
            inputs = gen.device_inputs(np.asarray([ids]), patches, tuple(grids),
                                       backend.prompt_bucket)
            _, last, _ = gen._prefill(*inputs[:4], tuple(grids), inputs[4], inputs[4] + 1)
        if hook:
            hook.remove()
        logits.append(last[0].float())
    sync_all(devices)
    return float(torch.nn.functional.cosine_similarity(logits[0], logits[1], dim=0))


def _judge_checks(tag: str, r: dict, base: dict, backend1, request: dict, model,
                  prec: str, tp: int) -> None:
    """Phase e's gates on one ``_judge_run`` against one card's (``base``):
    every wrapper call went to its kernel, and the kernels ran on every card
    of the model axis (K8 once a vision block a vision forward, K5 / K7 once
    a projection a decoder forward: two prefills, the timed one and
    ``start``'s, and the decode steps); then the logits cosine, at least the
    judge's gate (``TP_COSINE``) or, where rounding alone moves one card's
    logits further (``_noise_floor``: a random-weight model carries it
    through the full depth), twice the noise floor's distance from 1 (the
    fixed gates hold at 2 + 2 layers: ``_reduced_cosines``, and the f32
    model at full depth holds 1 - 1e-5: ``_f32_witness``), the greedy
    tokens (equal or a near-tie), KV bytes 1/tp of one card's and, in bf16
    at tp = 4, parameter bytes under 0.45 of one card's."""
    forwards, cards = r["forwards"], r["cards"]
    if forwards != {"text": 2 + TP_DECODE_STEPS, "vision": 2}:
        fail(f"{tag}: {forwards} forwards, expected 2 + {TP_DECODE_STEPS} decoder and 2 vision")
    want = {"frame_flash_attention": model.config.vision.depth * forwards["vision"]}
    kernel = {"int8": "linear_w8a8", "int4": "linear_w4a8"}.get(prec)
    if kernel:
        want[kernel] = 7 * model.config.text.num_layers * forwards["text"]
    for name, n in want.items():
        got = r["launches_by_card"].get(name, {})
        if got != {c: n for c in cards} or r["launches"][name] != n * len(cards):
            fail(f"{tag}: {name} calls by card {got}, launched {r['launches'][name]}; "
                 f"expected {n} on each of cards {cards}")
    if tp == 1:
        return
    gate = min(TP_COSINE[prec], 1 - 2 * (1 - base["noise_floor_cosine"]))
    if r["logits_cosine"] < gate:
        fail(f"{tag}: last-position logits cosine {r['logits_cosine']:.6f} to one card, "
             f"under {gate:.6f}")
    r["near_tie"] = _near_tie(tag, backend1, backend1._prepare(
        request["images"], request["prompt"], request["system"]), r["tokens"],
        base["tokens"], TP_NEAR_TIE[prec])
    if any(abs(v - 1 / tp) > 1e-9 for v in r["kv_share"].values()) or len(r["kv_share"]) != tp:
        fail(f"{tag}: KV bytes by card {r['kv_bytes']} not 1/{tp} of one card's")
    if prec == "bf16" and tp == 4 and max(r["param_share"].values()) >= 0.45:
        fail(f"{tag}: parameter bytes by card {r['param_share']} of one card's, not under 0.45")


def _k8_heads(device) -> list:
    """K8 at the vision tower's per-card shapes, (7, 1024, 16 / tp, 72) for
    tp = 1, 2, 4, on ``device``: against its plain version (max abs error),
    median ms of 100 single calls and the least of 3 chains of 20 (CUDA
    events), the plain version's and ``scaled_dot_product_attention``'s
    median ms, and the bound (the larger of q, k, v and the output over
    3.35 TB/s and 4 F H S^2 hd bf16 operations over 989 TFLOP/s)."""
    from emr2a_tpu_torch.ops import vision_flash

    def median(fn, iters=100):
        for _ in range(5):
            fn()
        times = []
        for _ in range(iters):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            fn()
            ev[1].record()
            ev[1].synchronize()
            times.append(ev[0].elapsed_time(ev[1]))
        return float(np.median(times))

    def chained(fn, n=20):
        best = None
        for _ in range(3):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            for _ in range(n):
                fn()
            ev[1].record()
            ev[1].synchronize()
            ms = ev[0].elapsed_time(ev[1]) / n
            best = ms if best is None else min(best, ms)
        return best

    g = torch.Generator(device=device).manual_seed(4)
    out = []
    with torch.cuda.device(device):
        for tp in TP_SIZES:
            F_, S, H, hd = 7, 1024, 16 // tp, 72
            q, k, v = (torch.randn(F_, S, H, hd, generator=g, device=device).to(torch.bfloat16)
                       for _ in range(3))
            scale = hd ** -0.5
            fn = lambda: vision_flash.frame_flash_attention(q, k, v, scale)
            ref = lambda: vision_flash.frame_flash_attention_reference(q, k, v, scale)
            err = float((fn().float() - ref().float()).abs().max())
            if err > 2e-2:
                fail(f"K8 at {(F_, S, H, hd)}: max abs error {err} against its plain version")
            by_bytes = 4 * q.numel() * q.element_size() / 3.35e12 * 1e3
            by_ops = 4 * F_ * H * S * S * hd / 989e12 * 1e3
            rec = {"shape": (F_, S, H, hd), "max_abs_err": err, "ms": median(fn),
                   "chained_ms": chained(fn), "plain_ms": median(ref, 20),
                   "library_ms": median(lambda: torch.nn.functional.scaled_dot_product_attention(
                       q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), scale=scale)),
                   "bound_ms": max(by_bytes, by_ops),
                   "bound_by": "bytes" if by_bytes > by_ops else "operations"}
            out.append(rec)
            print(f"K8 frame_flash_attention {rec['shape']} (the vision tower a card at tp = "
                  f"{tp}): {rec['ms']:.4f} ms (chained {rec['chained_ms']:.4f}), plain "
                  f"{rec['plain_ms']:.4f}, SDPA {rec['library_ms']:.4f}, bound "
                  f"{rec['bound_ms']:.4f} ({rec['bound_by']}), max abs error {err:.3g} "
                  f"(CUDA events, {device})", flush=True)
    return out


def _fold_requests(root: Path, manifest_path: Path) -> list:
    """The audit requests of the cohort's CV folds, as step4 builds them
    (``chip_smoke.fold_requests``)."""
    from collections import Counter

    from emr2a_tpu_torch.data.manifest import load_manifest
    from emr2a_tpu_torch.judge.audit import VLMAuditModule
    from emr2a_tpu_torch.judge.backends import FakeVLMBackend
    from emr2a_tpu_torch.pipelines.step4_vlm_review.run import (
        load_retrieval_results_from_folds,
    )
    data = load_retrieval_results_from_folds(root / "cv" / "exp_cohort", 100)
    by_id = {r["patient_id"]: r for r in load_manifest(manifest_path)}
    manifest = list(by_id.values())
    audit = VLMAuditModule(backend=FakeVLMBackend())
    out = []
    for pid, labels, scores, pids in zip(data["test_patient_ids"], data["all_top_labels"],
                                         data["all_top_scores"], data["all_top_patient_ids"]):
        neighbors = [(n, label, float(score)) for label, score, n in zip(labels, scores, pids)]
        evidence = audit.construct_evidence_package(by_id[pid], neighbors, manifest, root)
        out.append(audit._build_audit_request(evidence, Counter(labels).most_common(1)[0][0]))
    return out


def _cohort(root: Path, device: str) -> tuple:
    """The synthetic cohort, step1's manifest of it, a 3-fold CV over seeded
    embeddings (``exp_cohort``) and the 7-slice audit request of
    ``chip_smoke.py``'s judge phase."""
    from emr2a_tpu_torch.analysis import run_cv_experiments as runner
    from emr2a_tpu_torch.data.manifest import load_manifest
    from emr2a_tpu_torch.judge.audit import VLMAuditModule
    from emr2a_tpu_torch.judge.backends import FakeVLMBackend
    from emr2a_tpu_torch.pipelines.step1_manifest import build_manifest as step1
    from emr2a_tpu_torch.tools.cohort import write_cohort

    write_cohort(root / "cohort")
    step1.main(["--data_root", str(root / "cohort"), "--out_dir", str(root / "step1"),
                "--relative_paths", "false"])
    manifest_path = root / "step1" / "manifest.jsonl"
    manifest = load_manifest(manifest_path)
    rng = np.random.RandomState(1)
    pids = [r["patient_id"] for r in manifest]
    centers = rng.randn(4, DIM)
    labels = sorted({r["label"] for r in manifest})
    img = np.stack([centers[labels.index(r["label"])] + 4 * rng.randn(DIM) for r in manifest])
    np.savez_compressed(root / "emb.npz", patient_ids=np.asarray(pids),
                        image_matrix=img.astype(np.float32),
                        text_matrix=rng.randn(len(pids), DIM).astype(np.float32))
    runner.main(["--manifest_path", str(manifest_path), "--output_dir", str(root / "cv"),
                 "--experiment_id", "cohort", "--skip_encoding", "--embeddings_path",
                 str(root / "emb.npz"), "--device", device, "--fusion", "concat",
                 "--cv_folds", "3"])
    audit = VLMAuditModule(backend=FakeVLMBackend())
    neighbors = [(r["patient_id"], r["label"], 0.9 - 0.05 * i)
                 for i, r in enumerate(manifest[1:6])]
    evidence = audit.construct_evidence_package(manifest[0], neighbors, manifest, root)
    request = audit._build_audit_request(evidence, manifest[0]["label"])
    if len(request["images"]) != 7:
        fail(f"the audit request has {len(request['images'])} images, expected 7")
    return manifest_path, request


def _serving(backends: dict, requests: list, devices) -> dict:
    """The continuous batcher over the fold requests at ``TP_SLOTS`` slots
    on each backend (greedy, ``SERVING_BUDGETS``): cases/s by the host
    clock, and every stream against the first backend's."""
    from emr2a_tpu_torch.models.serving import ContinuousBatcher
    from emr2a_tpu_torch.tools.profile_judge import SERVING_BUDGETS
    out, rows = {}, {}
    for tag, be in backends.items():
        prepared = [be._prepare(r["images"], r["prompt"], r["system"]) for r in requests]
        bucket = -(-max(len(p[0]) for p in prepared) // be.prompt_bucket) * be.prompt_bucket
        reqs = [{"input_ids": np.asarray([ids], np.int64), "pixel_patches": patches,
                 "grid_thw": tuple(grids), "max_new_tokens": b}
                for (ids, patches, grids), b in zip(prepared, SERVING_BUDGETS)]
        srv = ContinuousBatcher(be.generator.model, n_slots=TP_SLOTS, prompt_bucket=bucket,
                                max_new_tokens=max(SERVING_BUDGETS),
                                eos_token_id=be.generator.eos_token_id)
        # a short first wave allocates the slot state (and on one card
        # captures the chunk step's graph), which the timed wave reuses
        srv.serve([dict(r, max_new_tokens=2) for r in reqs[:2]])
        sync_all(devices)
        t0 = time.time()
        rows[tag] = srv.serve(reqs)
        sync_all(devices)
        wall = time.time() - t0
        srv.release()
        out[tag] = {"cases_per_s": len(reqs) / wall, "wall_s": wall,
                    "tokens": int(sum(min(len(r), b) for r, b in zip(rows[tag], SERVING_BUDGETS)))}
        print(f"tp serving {tag}: {len(reqs)} fold requests at {TP_SLOTS} slots, "
              f"{out[tag]['cases_per_s']:.3f} cases/s ({wall:.2f} s, host clock)", flush=True)
    first = next(iter(backends))
    base = backends[first]
    for tag in list(backends)[1:]:
        ties = []
        for i, (got, want) in enumerate(zip(rows[tag], rows[first])):
            r = requests[i]
            tie = _near_tie(f"tp serving {tag} request {i}", base,
                            base._prepare(r["images"], r["prompt"], r["system"]), got, want,
                            TP_NEAR_TIE["bf16"])
            if tie:
                ties.append((i,) + tie)
        out[tag]["near_ties"] = ties
        print(f"tp serving {tag}: every stream equal to {first}'s"
              + (f" but near-ties (request, token, gap) {ties}" if ties else ""), flush=True)
    return out


def _reduced(cfg, state: dict):
    """The 8B cut to 2 vision blocks (deepstack at 0) and 2 text layers at
    full width (``chip_smoke.reduced_state``): (config, state)."""
    import re

    from emr2a_tpu_torch.models.qwen3_vl import Qwen3VLConfig
    small = Qwen3VLConfig(
        vision=dataclasses.replace(cfg.vision, depth=2, deepstack_visual_indexes=(0,)),
        text=dataclasses.replace(cfg.text, num_layers=2))
    keep = re.compile(r"visual\.(blocks\.[01]\.|deepstack_mergers\.0\.|merger\.|"
                      r"patch_embed\.|pos_embed)|language_model\.(layers\.[01]\.|"
                      r"embed_tokens|final_ln|lm_head)")
    return small, {k: v for k, v in state.items() if keep.match(k)}


def _reduced_cosines(cfg, state: dict, request: dict, tok) -> dict:
    """The judge's fixed logits gates (``TP_COSINE``, ``chip_smoke.py``'s
    reduced-depth limits) at the depth they were set for: the 8B cut to 2 +
    2 layers at full width, in bf16, int8 and int4, the last-position
    prefill logits at tp = 2 and 4 against tp = 1."""
    from emr2a_tpu_torch.judge.qwen_backend import QwenVLBackend, quantize_decoder
    small, small_state = _reduced(cfg, state)
    out = {}
    for prec in TP_PRECISIONS:
        qstate = quantize_decoder(small_state, prec)
        logits = {}
        for tp in TP_SIZES:
            be = QwenVLBackend(config=small, params=qstate, tokenizer=tok, precision="bf16",
                               tp=tp)
            logits[tp] = _forced_logits(be, be._prepare(request["images"], request["prompt"],
                                                        request["system"]), [])
        out[prec] = {tp: float(torch.nn.functional.cosine_similarity(
            logits[tp], logits[1].to(logits[tp].device), dim=0)) for tp in TP_SIZES[1:]}
        print(f"tp {prec} at 2 + 2 layers, full width: last-position logits cosine to one "
              f"card {out[prec]} (gate {TP_COSINE[prec]})", flush=True)
        if min(out[prec].values()) < TP_COSINE[prec]:
            fail(f"{prec} at 2 + 2 layers: logits cosine {out[prec]} under {TP_COSINE[prec]}")
    return out


def _f32_witness(request: dict, tok, devices) -> dict:
    """The model axis without bf16's rounding chaos: Qwen3-VL-8B at full
    depth and width with f32 weights (random, seed 0; the vision attention
    on its f32 plain path, K8 taking bf16 only), the last-position prefill
    logits at tp = 2 and 4 against tp = 1 on the first card, each backend
    built and released in turn. One card's and the shards' f32 sums differ
    by rounding at the 1e-7 level, so the cosine stays above
    ``TP_F32_COSINE``, where a shard fault that the bf16 model's depth
    would hide in its noise (a bias added on every card, a wrong rotary or
    head slice on one card) falls far below it."""
    from emr2a_tpu_torch.judge.qwen_backend import QwenVLBackend
    from emr2a_tpu_torch.models.qwen3_vl import qwen3_vl_8b_config, random_state
    cfg = qwen3_vl_8b_config(torch.float32)
    cfg = dataclasses.replace(cfg, vision=dataclasses.replace(cfg.vision, attn_impl="einsum"))
    t0 = time.time()
    state = random_state(cfg, seed=0, device=str(devices[0]))
    logits = {}
    for tp in TP_SIZES:
        be = QwenVLBackend(config=cfg, params=state, tokenizer=tok, precision="bf16", tp=tp)
        logits[tp] = _forced_logits(be, be._prepare(request["images"], request["prompt"],
                                                    request["system"]), []).to(devices[0])
        be.generator.release()
        del be
        torch.cuda.empty_cache()
    del state
    torch.cuda.empty_cache()
    out = {}
    for tp in TP_SIZES[1:]:
        d = logits[tp] - logits[1]
        out[tp] = {"cosine": float(torch.nn.functional.cosine_similarity(
                       logits[tp], logits[1], dim=0)),
                   "max_abs_diff": float(d.abs().max()),
                   "max_abs_logit": float(logits[1].abs().max()),
                   "argmax_equal": int(logits[tp].argmax()) == int(logits[1].argmax())}
    print(f"tp f32 witness, full depth and width: last-position logits against one card "
          f"{out} (gate cosine {TP_F32_COSINE}) in {time.time() - t0:.1f} s", flush=True)
    low = {tp: r["cosine"] for tp, r in out.items() if r["cosine"] < TP_F32_COSINE}
    if low:
        fail(f"f32 at full depth: logits cosine {low} under {TP_F32_COSINE}")
    return out


def _step4_cli(root: Path, manifest_path: Path, cfg, state: dict, devices) -> dict:
    """step4's CLI with ``--tp 2`` and ``--tp 1`` on the cohort's CV, the
    judge cut to 2 vision blocks and 2 text layers at full width (the
    checkpoint loader returns it; a stub ``transformers`` hands the CLI the
    stub tokenizer): the audit files compared, and each case's greedy
    stream (recorded from the two CLIs' generators) equal or first
    different at a near-tie of one card's logits."""
    import types

    from emr2a_tpu_torch.judge import audit
    from emr2a_tpu_torch.models import checkpoint
    from emr2a_tpu_torch.pipelines.step4_vlm_review import run as step4
    from emr2a_tpu_torch.tools.stub_tokenizer import WordTokenizer

    small, small_state = _reduced(cfg, state)
    stub = types.ModuleType("transformers")
    stub.AutoTokenizer = types.SimpleNamespace(from_pretrained=lambda *a, **k: WordTokenizer())
    made = {}

    def recording(*a, **kw):
        be = audit_load(*a, **kw)
        calls = made.setdefault(kw.get("tp", 1), (be, []))[1]
        plain = be.generator.generate

        def generate(input_ids, pixel_patches=None, grid_thw=(), **rest):
            rows = plain(input_ids, pixel_patches=pixel_patches, grid_thw=grid_thw, **rest)
            calls.append(((list(np.asarray(input_ids)[0]), pixel_patches, tuple(grid_thw)),
                          rows[0]))
            return rows

        be.generator.generate = generate
        return be

    audit_load = audit.load_backend
    saved = (sys.modules.get("transformers"), checkpoint.load_qwen3_vl)
    sys.modules["transformers"] = stub
    checkpoint.load_qwen3_vl = lambda path, **kw: (small, small_state)
    audit.load_backend = recording
    out = {}
    try:
        for tp in (1, 2):
            t0 = time.time()
            step4.main(["--exp_dir", str(root / "cv" / "exp_cohort"), "--manifest_path",
                        str(manifest_path), "--output_dir", str(root / f"step4_tp{tp}"),
                        "--model_path", str(root / "reduced_8b"), "--max_samples",
                        str(TP_STEP4_CASES), "--vlm_max_new_tokens", str(TP_STEP4_TOKENS),
                        "--tp", str(tp), "--device", devices[0].type])
            sync_all(devices)
            out[f"tp{tp}_s"] = time.time() - t0
    finally:
        if saved[0] is None:
            sys.modules.pop("transformers", None)
        else:
            sys.modules["transformers"] = saved[0]
        checkpoint.load_qwen3_vl = saved[1]
        audit.load_backend = audit_load

    def listing(tp):
        top = root / f"step4_tp{tp}"
        return sorted(str(p.relative_to(top)) for p in top.rglob("*") if p.is_file())

    files = listing(1)
    if files != listing(2):
        fail(f"step4 --tp 2: files {listing(2)} differ from --tp 1's {files}")
    details = [(root / f"step4_tp{tp}" / "vlm_audit_details.jsonl").read_text().splitlines()
               for tp in (1, 2)]
    if len(details[0]) != TP_STEP4_CASES or len(details[1]) != TP_STEP4_CASES:
        fail(f"step4 --tp: {len(details[0])} and {len(details[1])} audited cases")
    out["files"] = files
    out["equal"] = {name: (root / "step4_tp1" / name).read_bytes()
                    == (root / "step4_tp2" / name).read_bytes() for name in files}
    out["equal_cases"] = sum(a == b for a, b in zip(*details))
    (base, want), (_, got) = made[1], made[2]
    if len(want) != TP_STEP4_CASES or len(got) != TP_STEP4_CASES:
        fail(f"step4 --tp: {len(want)} and {len(got)} generations recorded")
    ties = []
    for i, ((prepared, row1), (prepared2, row2)) in enumerate(zip(want, got)):
        if prepared[0] != prepared2[0]:
            fail(f"step4 --tp 2: case {i}'s prompt differs from --tp 1's")
        tie = _near_tie(f"step4 --tp 2 case {i}", base, prepared, row2, row1,
                        TP_NEAR_TIE["bf16"])
        if tie:
            ties.append((i,) + tie)
    out["near_ties"] = ties
    print(f"step4 CLI --tp 2 against --tp 1 (Qwen3-VL-8B at 2 + 2 layers, full width, "
          f"{TP_STEP4_CASES} cases, {TP_STEP4_TOKENS} new tokens): files {files}, byte-equal "
          f"{out['equal']}; {out['equal_cases']} of {TP_STEP4_CASES} detail rows equal; "
          f"streams equal but near-ties (case, token, gap) {ties}; "
          f"{out['tp1_s']:.1f} s / {out['tp2_s']:.1f} s (host clock, load included)", flush=True)
    return out


def _trainer(devices) -> dict:
    """The contrastive trainer at BioMedCLIP's width (ViT-B/16 and
    PubMedBERT-256, unfused, f32, batch 32, lr 1e-4) for 3 steps on one card
    and over the meshes of ``TP_TRAIN_MESHES``: losses within rtol 1e-4 of
    one card's, ms a step (CUDA events on the first card, after a
    synchronize of every card)."""
    from emr2a_tpu_torch.encoders.biomedclip_encoder import default_biomedclip_config
    from emr2a_tpu_torch.models.clip import BioMedCLIPImageTower, BioMedCLIPTextTower, init_tower
    from emr2a_tpu_torch.parallel import create_mesh
    from emr2a_tpu_torch.training import ContrastiveTrainer

    cfg = default_biomedclip_config()
    gen = torch.Generator().manual_seed(0)
    image = init_tower(BioMedCLIPImageTower(cfg), gen)
    text = init_tower(BioMedCLIPTextTower(cfg), gen)
    params = {"image": dict(image.state_dict()), "text": dict(text.state_dict())}
    g = torch.Generator().manual_seed(7)
    side, length = cfg.vision.image_size, cfg.text.max_length
    ids = torch.randint(4, 30000, (TP_TRAIN_BATCH, length), generator=g)
    ids[:, 0], ids[:, -1] = 2, 3
    batch = (torch.randn(TP_TRAIN_BATCH, side, side, 3, generator=g), ids,
             torch.ones_like(ids))
    out = {}
    runs = [("1 card", None)] + [(f"mesh {s}", create_mesh(s, devices=devices[:s[0] * s[1]]))
                                 for s in TP_TRAIN_MESHES]
    for tag, mesh in runs:
        trainer = ContrastiveTrainer(image.to(devices[0]) if mesh is None else image,
                                     text.to(devices[0]) if mesh is None else text,
                                     mesh=mesh, learning_rate=TP_TRAIN_LR)
        placed = params if mesh is not None else {
            t: {k: v.to(devices[0]) for k, v in p.items()} for t, p in params.items()}
        state = trainer.init_state(placed)
        step = trainer.make_train_step()
        data = tuple(x.to(devices[0]) for x in batch)
        losses, times = [], []
        for _ in range(TP_TRAIN_STEPS):
            sync_all(devices)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            state, loss = step(state, *data)
            sync_all(devices)
            ev[1].record()
            ev[1].synchronize()
            times.append(ev[0].elapsed_time(ev[1]))
            losses.append(float(loss))
        out[tag] = {"losses": losses, "ms_per_step": float(np.median(times[1:])),
                    "step_ms": times}
        image, text = image.cpu(), text.cpu()
        del trainer, state
        torch.cuda.empty_cache()
        print(f"trainer {tag}: losses {losses}, {out[tag]['ms_per_step']:.2f} ms a step "
              f"(median of steps 2 to {TP_TRAIN_STEPS}, CUDA events)", flush=True)
    ref = out["1 card"]["losses"]
    for tag, r in out.items():
        if not np.allclose(r["losses"], ref, rtol=1e-4, atol=0):
            fail(f"trainer {tag}: losses {r['losses']} against one card's {ref}")
    return out


def tp_phase(devices) -> dict:
    """(e) The model axis: see the module docstring."""
    from emr2a_tpu_torch.judge.qwen_backend import QwenVLBackend, quantize_decoder
    from emr2a_tpu_torch.models.qwen3_vl import qwen3_vl_8b_config, random_state
    from emr2a_tpu_torch.tools.stub_tokenizer import WordTokenizer

    if len(devices) < max(TP_SIZES):
        fail(f"phase e needs {max(TP_SIZES)} cards, found {len(devices)}")
    out = {"judge": {}}
    gates = _Gates()
    with tempfile.TemporaryDirectory(prefix="multichip_tp_") as tmp:
        root = Path(tmp)
        t0 = time.time()
        manifest_path, request = _cohort(root, devices[0].type)
        print(f"tp: cohort, step1 and a 3-fold CV in {time.time() - t0:.1f} s", flush=True)
        out["k8"] = _k8_heads(devices[0])
        cfg = qwen3_vl_8b_config(torch.bfloat16)
        state = random_state(cfg, seed=0, device=str(devices[0]))
        tok = WordTokenizer()
        serving = {}
        for prec in TP_PRECISIONS:
            t0 = time.time()
            qstate = quantize_decoder(state, prec)
            runs, backends = {}, {}
            for tp in TP_SIZES:
                # a backend builds its (cards // tp, tp) mesh over every card
                backends[tp] = QwenVLBackend(config=cfg, params=qstate, tokenizer=tok,
                                             precision="bf16", tp=tp)
                tag = f"{prec} tp={tp}"
                runs[tp] = r = _judge_run(tag, backends[tp], request, devices, prec)
                base = runs[1]
                r["near_tie"] = None
                if tp == 1:
                    r["noise_floor_cosine"] = _noise_floor(backends[1], request, devices)
                    print(f"tp {tag}: one bf16 ulp on 16 input elements moves the last-position "
                          f"logits to cosine {r['noise_floor_cosine']:.7f} (the rounding noise "
                          f"floor)", flush=True)
                if tp > 1:
                    r["logits_cosine"] = float(torch.nn.functional.cosine_similarity(
                        r["logits"], base["logits"].to(r["logits"].device), dim=0))
                    r["param_share"] = {c: b / base["param_bytes"][0]
                                        for c, b in r["param_bytes"].items()}
                    r["kv_share"] = {c: b / base["kv_bytes"][0] for c, b in r["kv_bytes"].items()}
                with gates.check(tag):
                    _judge_checks(tag, r, base, backends[1], request, backends[tp].model,
                                  prec, tp)
                print(f"tp {tag}: {r['prompt_tokens']} prompt tokens (bucket {r['padded']}); "
                      f"prefill {r['prefill_ms']:.3f} ms, eager decode "
                      f"{r['decode_ms_per_token']:.3f} ms/token (CUDA events, "
                      f"{TP_DECODE_STEPS} steps); tokens "
                      + ("(reference)" if tp == 1 else
                         f"{'equal' if not r['near_tie'] else 'near-tie ' + str(r['near_tie'])}"
                         f", logits cosine {r['logits_cosine']:.7f}")
                      + f"; param GiB by card {({c: round(b / 2**30, 3) for c, b in r['param_bytes'].items()})}"
                      f"; KV MiB by card {({c: round(b / 2**20, 2) for c, b in r['kv_bytes'].items()})}"
                      f"; peak GiB by card {({c: round(g, 2) for c, g in r['peak_gib'].items() if g})}"
                      f"; calls by card {r['launches_by_card']}", flush=True)
            for r in runs.values():
                r["logits"] = None
            out["judge"][prec] = runs
            if prec == "bf16":
                requests = _fold_requests(root, manifest_path)
                with gates.check("serving"):
                    serving = _serving({"tp=1": backends[1], "tp=2": backends[2]}, requests,
                                       devices)
            for be in backends.values():
                be.generator.release()
            del backends, qstate
            torch.cuda.empty_cache()
            print(f"tp {prec}: {time.time() - t0:.1f} s", flush=True)
        out["serving"] = serving
        with gates.check("reduced depth"):
            out["reduced"] = _reduced_cosines(cfg, state, request, tok)
        with gates.check("step4 --tp"):
            out["step4"] = _step4_cli(root, manifest_path, cfg, state, devices)
        del state
        torch.cuda.empty_cache()
        with gates.check("f32 witness"):
            out["f32"] = _f32_witness(request, tok, devices)
    with gates.check("trainer"):
        out["trainer"] = _trainer(devices)
    if gates.failed:
        fail("; ".join(gates.failed))
    return out


# -- (f) one process a card -------------------------------------------------

def _rank_timing_line(name: str, rec: dict) -> str:
    q = rec["search_ms_quartiles"]
    return (f"p50 {rec['p50_ms']:.4f} ms (3 runs of 256 chained); alone p50 {q[1]:.4f} "
            f"(quartiles {q[0]:.4f}-{q[2]:.4f}): scan {rec['scan_ms']:.4f} + all-gather "
            f"{rec['all_gather_ms']:.4f} + merge {rec['merge_ms']:.4f}; host "
            f"{rec['host_ms_per_search']:.4f} ms a search; q=64 {rec['q64_ms']:.4f} ms")


def processes_phase(devices, rows: int) -> dict:
    from emr2a_tpu_torch.parallel import create_mesh
    from emr2a_tpu_torch.parallel.launch import WorkerFailed, launch
    from emr2a_tpu_torch.retrieval.database import ShardedEmbeddingDatabase
    from emr2a_tpu_torch.retrieval.database_cli import chained_p50_ms
    from emr2a_tpu_torch.tools.db_processes import CHECKS, DTYPES, seeded_rows, write_rows

    n = len(devices)
    worker = ["-m", "emr2a_tpu_torch.tools.db_processes"]
    repo = str(Path(__file__).resolve().parents[2])
    out = {"rows": rows, "processes": n,
           "nccl": {"is_nccl_available": torch.distributed.is_nccl_available(),
                    "version": ".".join(map(str, torch.cuda.nccl.version()))}}
    print(f"processes: torch.distributed.is_nccl_available() {out['nccl']['is_nccl_available']}, "
          f"NCCL {out['nccl']['version']}", flush=True)
    t0 = time.time()
    try:
        ranks = launch([*worker, "--case", "jax"], 2, timeout=120,
                       env={**os.environ, "CUDA_VISIBLE_DEVICES": ""}, cwd=repo)
    except WorkerFailed as e:
        fail(f"processes, JAX's worker case on the CPU: {e}")
    if not all(f"p{r}: sharded retrieval over processes OK" in ranks for r in range(2)):
        fail(f"processes, JAX's worker case: {ranks}")
    print(f"processes: JAX's worker case (16 x 8, n_total 14, k 5) on 2 CPU processes (gloo): "
          f"equal to numpy ({time.time() - t0:.1f} s)", flush=True)

    emb, batch = seeded_rows(rows)
    one = create_mesh((1, 1), devices=devices[:1])
    every = create_mesh((n, 1), devices=devices)
    refs, out["one_process"] = {}, {}
    for name, dtype in DTYPES.items():
        for tag, mesh in (("1 card", one), (f"{n} cards, 1 process", every)):
            db = ShardedEmbeddingDatabase(emb, mesh=mesh, dtype=dtype, use_pallas=True,
                                          normalize=False)
            refs[name, tag] = {f"q{nq}_k{k}": tuple(t.cpu().numpy() for t in db.topk(batch[:nq], k))
                               for nq, k in CHECKS}
            if mesh is every:
                qd = db._queries(batch, True)
                out["one_process"][name] = {
                    "p50_ms": chained_p50_ms(db, batch[0], 5, 256),
                    "q64_ms": _event_ms(lambda: db._scan(qd, 5), devices[0])}
                print(f"processes {name}: one process over {n} cards, p50 "
                      f"{out['one_process'][name]['p50_ms']:.4f} ms, q=64 "
                      f"{out['one_process'][name]['q64_ms']:.4f} ms (phase b's timing, "
                      f"this call)", flush=True)
            del db
            sync_all(devices)
            torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="multichip_processes_") as tmp:
        t0 = time.time()
        write_rows(Path(tmp), emb, batch)
        out["write_s"] = time.time() - t0
        del emb
        t0 = time.time()
        try:
            ranks = launch([*worker, "--case", "measure", "--dir", tmp], n, timeout=600,
                           cwd=repo)
        except WorkerFailed as e:
            fail(f"processes, one a card: {e}")
        out["ranks_s"] = time.time() - t0
        print("\n".join(line for line in ranks.splitlines() if line.startswith("[default0]:")),
              flush=True)
        records = [json.loads((Path(tmp) / f"rank{r}.json").read_text()) for r in range(n)]
        out["ranks"] = records
        for name in DTYPES:
            kernel = "cosine_topk_fused_int8" if name == "int8" else "cosine_topk_fused"
            for r, rec in enumerate(records):
                if rec["dtypes"][name]["launches"][kernel] != len(CHECKS):
                    fail(f"processes {name}: rank {r} launched {kernel} "
                         f"{rec['dtypes'][name]['launches']} for {len(CHECKS)} searches")
                got = np.load(Path(tmp) / f"rank{r}_{name}.npz")
                for key in refs[name, "1 card"]:
                    vals, idx = got[f"{key}_vals"], got[f"{key}_idx"]
                    for tag in ("1 card", f"{n} cards, 1 process"):
                        want_vals, want_idx = refs[name, tag][key]
                        if not np.array_equal(idx, want_idx):
                            fail(f"processes {name} {key}: rank {r}'s indices differ from "
                                 f"{tag}'s")
                        if not np.array_equal(vals.view(np.int32), want_vals.view(np.int32)):
                            fail(f"processes {name} {key}: rank {r}'s values are not "
                                 f"bit-identical to {tag}'s")
            print(f"processes {name}: {n} processes, one card each: every rank's indices "
                  f"equal one card's and one process's over {n} cards at q=1 k=5, q=64 k=5 "
                  f"and k=100, values bit-identical; K6 launches a rank "
                  f"{[rec['dtypes'][name]['launches'] for rec in records]}", flush=True)
            for r, rec in enumerate(records):
                print(f"processes {name} rank {r} ({rec['device']}): "
                      + _rank_timing_line(name, rec["dtypes"][name]), flush=True)
        print(f"processes: {n} ranks in {out['ranks_s']:.1f} s (torchrun; the rows written "
              f"in {out['write_s']:.1f} s, each rank reading its shard's)", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default="a,b,c,d")
    ap.add_argument("--report_only", action="store_true",
                    help="phase a: record failed launches and differences, do not fail")
    ap.add_argument("--db_rows", type=int, default=4 << 20)
    ap.add_argument("--cli_rows", type=int, default=1 << 16)
    ap.add_argument("--per_card", type=int, default=128)
    ap.add_argument("--patients", type=int, default=8)
    ap.add_argument("--slices", type=int, default=192)
    ap.add_argument("--batch", type=int, default=96)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    n = torch.cuda.device_count()
    if n < 2:
        raise SystemExit(f"multichip_smoke needs at least 2 CUDA devices, found {n}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    devices = [torch.device("cuda", i) for i in range(n)]
    print(cards_text(), flush=True)
    print(host_line(), flush=True)
    phases = args.phases.split(",")
    from emr2a_tpu_torch.ops import _build
    t0 = time.time()
    _build.library()
    print(f"kernels built in {time.time() - t0:.1f} s", flush=True)
    result = {"cards": cards_text().splitlines(), "host": host_line()}
    try:
        if "a" in phases:
            result["a"] = kernels_on_every_card(devices, args.report_only)
        if "b" in phases:
            result["b"] = database_phase(devices, args.db_rows, args.cli_rows)
        if "c" in phases:
            result["c"] = tower_phase(devices, args.per_card)
        if "d" in phases:
            result["d"] = step2_phase(devices, args.patients, args.slices, args.batch)
        if "e" in phases:
            result["e"] = tp_phase(devices)
        if "f" in phases:
            result["f"] = processes_phase(devices, args.db_rows)
    except Failure as e:
        print(f"FAIL: {e}", file=sys.stderr, flush=True)
        return 1
    finally:
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps({"ok": True, "cards": n, "phases": phases}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
