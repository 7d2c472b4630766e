"""The port on several cards of one host: the mesh's data axis.

    python -m emr2a_tpu_torch.tools.multichip_smoke [--phases a,b,c,d] [--out FILE]

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

``--out`` writes every record as JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
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
