"""Where the step4 judge's time goes on one CUDA card.

    python -m emr2a_tpu_torch.tools.profile_judge [--precision bf16 int8 int4] \\
        [--decode_steps 16] [--serving_slots 8] [--out profile.json]

Qwen3-VL-8B at full width with random weights (``random_state(seed=0)``,
bf16, on the card) and one 7-image audit request built as step4 builds it
(4 query slices and the first slice of 3 neighbours of a synthetic CT
cohort, 512x512; the audit prompt; the stub word-level tokenizer), per
precision (``QwenVLBackend(precision=...)``):

1. prefill (vision tower + decoder over the padded prompt + the last
   position's logits): wall from CUDA events over 3 runs after a warm-up,
   and ``torch.profiler`` device time per kernel group over one more;
2. decode: the same over ``--decode_steps`` greedy steps, per token, run
   eagerly (``Qwen3VLGenerator.decode_step``, one host launch a kernel);
3. decode replayed from a CUDA graph (``models/cuda_graph.StepGraph``, the
   generator's path on the card), from the same state;
4. with ``--serving_slots N``: one continuous-batching wave
   (``QwenVLBackend.generate_stream``, N slots) of the cohort's 12 audit
   requests with new-token budgets of 16 to 64 (``SERVING_BUDGETS``), after
   a warm-up wave: host wall, the backend's host preprocessing, and the
   device time by kernel group over the profiled wave.

The device's busy share is the profiled device time over the profiled
run's own wall. Prints one line per number and, last, one JSON object with
all of them (also written to ``--out`` when given).
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from emr2a_tpu_torch.models.cuda_graph import StepGraph

# kernel name pattern -> group; the first pattern that matches names it
_GROUPS = (
    (r"frame_attention_kernel", "K8 vision attention"),
    (r"linear_gemv_kernel<\d+, true>", "K7 GEMV (T <= 16)"),
    (r"linear_gemv_kernel<\d+, false>", "K5 GEMV (T <= 16)"),
    (r"gemm_s8_wgmma_kernel<true", "K7 wgmma GEMM"),
    (r"gemm_s8_wgmma_kernel<false, ?2, ?\d+, ?0, ?1>", "K5 wgmma GEMM"),
    (r"quantize_rows_kernel", "row quantize (K5, K7 at T > 16)"),
    (r"(?i)softmax", "softmax"),
    (r"gemm|gemv|xmma|cutlass|nvjet|cublas|splitK", "cuBLAS products"),
)


def group_of(name: str) -> str:
    for pattern, label in _GROUPS:
        if re.search(pattern, name):
            return label
    return "elementwise, reductions, copies"


def _self_device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


# the serving wave's new-token budgets, one a request (heterogeneous, so
# that slots refill); chip_smoke.py's serving phase uses the same
SERVING_BUDGETS = (16, 64, 24, 40, 16, 56, 32, 64, 48, 16, 40, 24)


def audit_requests(work: Path, n: int = 1) -> list:
    """``n`` audit requests of a synthetic cohort, as step4 builds them:
    patient q as the query, the next five as neighbours."""
    from emr2a_tpu_torch.data.manifest import load_manifest
    from emr2a_tpu_torch.judge.audit import VLMAuditModule
    from emr2a_tpu_torch.judge.backends import FakeVLMBackend
    from emr2a_tpu_torch.tools.cohort import write_cohort

    manifest = load_manifest(write_cohort(work, n_patients=max(6, n), n_slices=8))
    audit = VLMAuditModule(backend=FakeVLMBackend())
    requests = []
    for q in range(n):
        others = manifest[q + 1:] + manifest[:q]
        neighbors = [(r["patient_id"], r["label"], 0.9 - 0.05 * i)
                     for i, r in enumerate(others[:5])]
        evidence = audit.construct_evidence_package(manifest[q], neighbors, manifest, work)
        requests.append(audit._build_audit_request(evidence, manifest[q]["label"]))
    return requests


def profile_serving(backend, requests: list, slots: int) -> dict:
    """One continuous wave of ``requests`` after a warm-up wave: host wall,
    host preprocessing, device time by kernel group and busy share."""
    from torch.profiler import ProfilerActivity, profile
    reqs = [dict(r, max_new_tokens=b) for r, b in zip(requests, SERVING_BUDGETS)]

    def wave():
        return backend.generate_stream(reqs, max_new_tokens=max(SERVING_BUDGETS),
                                       n_slots=slots)

    wave()                                          # warm-up
    host = [0.0]
    prepare = backend._prepare

    def timed_prepare(*args):
        t = time.perf_counter()
        out = prepare(*args)
        host[0] += time.perf_counter() - t
        return out

    backend._prepare = timed_prepare
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            wave()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    finally:
        backend._prepare = prepare
    groups: dict = {}
    for evt in prof.key_averages():
        us = _self_device_us(evt)
        if us > 0:
            g = groups.setdefault(group_of(evt.key), {"ms": 0.0, "launches": 0})
            g["ms"] += us / 1e3
            g["launches"] += evt.count
    device = sum(g["ms"] for g in groups.values())
    return {"requests": len(reqs), "slots": slots, "wall_ms": wall,
            "prepare_ms": host[0] * 1e3, "device_ms": device, "busy_share": device / wall,
            "groups": sorted(({"group": k, **v} for k, v in groups.items()),
                             key=lambda r: -r["ms"])}


def _timed(fn, iters: int) -> tuple:
    """(wall ms per run from CUDA events, profiled device time by group per
    run, profiled wall ms per run)."""
    from torch.profiler import ProfilerActivity, profile
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    wall = start.elapsed_time(end) / iters
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start.record()
        fn()
        end.record()
        end.synchronize()
    profiled_wall = start.elapsed_time(end)
    groups: dict = {}
    for evt in prof.key_averages():
        us = _self_device_us(evt)
        if us > 0:
            g = groups.setdefault(group_of(evt.key), {"ms": 0.0, "launches": 0})
            g["ms"] += us / 1e3
            g["launches"] += evt.count
    return wall, groups, profiled_wall


def profile_precision(backend, request: dict, decode_steps: int) -> dict:
    gen = backend.generator
    ids, patches, grids = backend._prepare(request["images"], request["prompt"],
                                           request["system"])
    grids = tuple(grids)
    with torch.inference_mode():
        ids_t, pos_t, tl, patches_t, padded = gen.device_inputs(
            np.asarray([ids]), patches, grids, backend.prompt_bucket)
        max_len = padded + decode_steps

        def prefill():
            gen._prefill(ids_t, pos_t, tl, patches_t, grids, padded, max_len)

        state = gen.start(np.asarray([ids]), patches, grids, decode_steps,
                          prompt_bucket=backend.prompt_bucket)
        token0 = state.token.clone()
        runner = StepGraph(gen.decode_step, state, state.token.device)

        def from_the_start(run):
            def go():
                state.step.zero_()
                state.token.copy_(token0)
                state.done.zero_()
                run()
            return go

        def decode():
            for _ in range(decode_steps):
                gen.decode_step(state)

        prefill()                                   # warm-up
        prefill_wall, prefill_groups, prefill_prof = _timed(prefill, 3)
        from_the_start(decode)()                    # warm-up
        decode_wall, decode_groups, decode_prof = _timed(from_the_start(decode), 2)
        from_the_start(lambda: runner.run(2))()     # warm-up, capture, a replay
        graph = _timed(from_the_start(lambda: runner.run(decode_steps)), 2)
    out = {"prompt_tokens": len(ids), "padded": padded, "images": len(grids)}
    for phase, wall, groups, prof_wall, per in (
            ("prefill", prefill_wall, prefill_groups, prefill_prof, 1),
            ("decode", decode_wall, decode_groups, decode_prof, decode_steps),
            ("graph decode", graph[0], graph[1], graph[2], decode_steps)):
        device = sum(g["ms"] for g in groups.values())
        rows = sorted(({"group": k, "ms": v["ms"] / per, "launches": v["launches"] / per,
                        "share": v["ms"] / device} for k, v in groups.items()),
                      key=lambda r: -r["ms"])
        out[phase] = {"wall_ms": wall / per, "device_ms": device / per,
                      "busy_share": device / prof_wall, "groups": rows}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--precision", nargs="+", default=["bf16", "int8", "int4"],
                    choices=["bf16", "int8", "int4"])
    ap.add_argument("--decode_steps", type=int, default=16)
    ap.add_argument("--serving_slots", type=int, default=None,
                    help="also profile one continuous wave of 12 requests at this "
                         "slot count")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_judge needs a CUDA card")
    from emr2a_tpu_torch.judge.qwen_backend import QwenVLBackend
    from emr2a_tpu_torch.models.qwen3_vl import qwen3_vl_8b_config, random_state
    from emr2a_tpu_torch.tools.stub_tokenizer import WordTokenizer

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    cfg = qwen3_vl_8b_config(torch.bfloat16)
    state = random_state(cfg, seed=0, device="cuda")
    with tempfile.TemporaryDirectory(prefix="profile_judge_") as tmp:
        requests = audit_requests(Path(tmp), 12 if args.serving_slots else 1)
        request = requests[0]
        result = {"card": card, "decode_steps": args.decode_steps}
        for prec in args.precision:
            backend = QwenVLBackend(config=cfg, params=state, tokenizer=WordTokenizer(),
                                    precision=prec)
            r = profile_precision(backend, request, args.decode_steps)
            result[prec] = r
            if args.serving_slots:
                w = r["serving"] = profile_serving(backend, requests, args.serving_slots)
                print(f"{prec} serving, {w['slots']} slots, {w['requests']} requests: "
                      f"{w['wall_ms']:.1f} ms (host clock), host preprocessing "
                      f"{w['prepare_ms']:.1f}, device {w['device_ms']:.1f}, busy share "
                      f"{w['busy_share']:.3f} ({card})", flush=True)
                for g in w["groups"]:
                    print(f"  {g['group']}: {g['ms']:.3f} ms, {g['launches']} launches",
                          flush=True)
            del backend
            torch.cuda.empty_cache()
            for phase in ("prefill", "decode", "graph decode"):
                p = r[phase]
                unit = "ms" if phase == "prefill" else "ms/token"
                print(f"{prec} {phase}: {p['wall_ms']:.3f} {unit} (CUDA events), device "
                      f"{p['device_ms']:.3f}, busy share {p['busy_share']:.3f} "
                      f"({r['images']} images, {r['prompt_tokens']} prompt tokens, "
                      f"bucket {r['padded']}; {card})", flush=True)
                for g in p["groups"]:
                    print(f"  {g['group']}: {g['ms']:.3f} ms, {g['share'] * 100:.1f} %, "
                          f"{g['launches']:.0f} launches", flush=True)
    line = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line)
    print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
