"""Where step2's time goes on one CUDA card, for the bf16 or the int8
kernel path.

    python -m emr2a_tpu_torch.tools.profile_tower [--fast int8] [--out profile.json]

Three measurements, all of BioMedCLIP ViT-B/16 at full width with random
weights (``BioMedCLIPEncoder.random_init(seed=0, fast=True)``, or
``fast="int8"`` with ``--fast int8``):

1. Tower: ``torch.profiler`` device time per kernel and per forward, at
   batch 32 and 128, over 5 forwards after warm-up; the wall per
   forward from CUDA events over the same count without the profiler; the
   device's busy share (device time over the profiled forwards' own wall);
   and the rate each kernel reaches from the operations its shapes give
   (FLOPs for bf16, s8 multiply-adds x 2 for int8).
2. Step2's stages per slice on a synthetic cohort of 512x512 PNGs: host
   decode (grey and RGB PNGs), host resize to 224, and the device path of
   one batch of 32 (H2D, preprocessing, tower, L2 normalisation, D2H).
3. Step2 end to end (``load_images`` -> ``encode_images``) on the grey and
   the RGB cohort.

Prints one line per number and, last, one JSON object with all of them
(also written to ``--out`` when given).
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

BATCHES = (32, 128)      # step2's device batch, and a saturating one
ITERS = 5                # profiled forwards per batch
COHORT = (4, 40)         # patients x 512x512 slices per PNG kind

# demangled kernel name -> (label, operations per launch as a function of
# (tokens T, batch B, padded sequence S)) at ViT-B: d=768, m=3072, 12 heads;
# the first pattern that matches names the kernel
_D, _M, _H = 768, 3072, 12
_KERNELS = (
    (r"attention_core_kernel<float>", "attention core, f32 out (K4)",
     lambda T, B, S: 4 * B * _H * S * S * (_D // _H)),
    (r"attention_core", "attention core (K3)",
     lambda T, B, S: 4 * B * _H * S * S * (_D // _H)),
    (r"layer_norm_rows_kernel", "LN row pass (K1, K3)", None),
    (r"gemm_bf16_kernel<\d+, ?0>", "Q/K/V GEMM (K3)",
     lambda T, B, S: 2 * T * _D * 3 * _D),
    (r"gemm_bf16_kernel<\d+, ?[13]>", "fc1 GEMM + gelu (K1)",
     lambda T, B, S: 2 * T * _D * _M),
    (r"gemm_bf16_kernel<\d+, ?2>", "fc2 and out-proj GEMM + residual (K1, K3)",
     lambda T, B, S: (2 * T * _M * _D + 2 * T * _D * _D) / 2),
    # the s8 wgmma GEMM <W4, MT, NT, epilogue, weights>: K4's Q/K/V is its
    # bf16 epilogue over 3 weights (K5's is the same epilogue over 1)
    (r"gemm_s8_wgmma_kernel<false, ?2, ?\d+, ?0, ?3>", "Q/K/V s8 GEMM (K4)",
     lambda T, B, S: 2 * T * _D * 3 * _D),
    (r"gemm_s8_wgmma_kernel<false, ?2, ?\d+, ?[13], ?1>", "fc1 s8 GEMM + gelu (K2)",
     lambda T, B, S: 2 * T * _D * _M),
    (r"gemm_s8_wgmma_kernel<false, ?2, ?\d+, ?2, ?1>",
     "fc2 and out-proj s8 GEMM + residual (K2, K4)",
     lambda T, B, S: (2 * T * _M * _D + 2 * T * _D * _D) / 2),
    (r"gemm_s8_wgmma_kernel<false, ?2, ?\d+, ?0, ?1>", "K5 wgmma GEMM", None),
    (r"quantize_rows_kernel<__nv_bfloat16, ?true>", "LN + row quantize (K2, K4)",
     None),
    (r"quantize_rows_kernel<float, ?false>",
     "row quantize of f32 h1 and P.V (K2, K4)", None),
)
def kernel_label(key: str, T: int, B: int, S: int):
    """(label, operations per launch or None) of a demangled kernel name."""
    for pattern, name, ops in _KERNELS:
        if re.search(pattern, key):
            return name, ops and ops(T, B, S)
    return key[:100], None


def _self_device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def profile_tower(encoder, batch: int, iters: int) -> dict:
    from emr2a_tpu_torch.ops.preprocess import preprocess_images
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device="cuda").manual_seed(batch)
    images = torch.randint(0, 256, (batch, 224, 224, 3), dtype=torch.uint8,
                           device="cuda", generator=g)
    tower = encoder.image_model
    trunk = tower.trunk
    seq = trunk.config.num_patches + 1
    S = seq + (-seq) % 8
    layers = len(trunk.blocks)
    with torch.inference_mode():
        pixels = preprocess_images(images, encoder.preprocess)
        for _ in range(3):
            tower(pixels)
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(iters):
            tower(pixels)
        end.record()
        end.synchronize()
        wall_ms = start.elapsed_time(end) / iters
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            start.record()
            for _ in range(iters):
                tower(pixels)
            end.record()
            end.synchronize()
        profiled_ms = start.elapsed_time(end) / iters

    rows = []
    for evt in prof.key_averages():
        us = _self_device_us(evt)
        if us <= 0:
            continue
        label, ops = kernel_label(evt.key, batch * S, batch, S)
        ms = us / 1e3 / iters
        launches = evt.count / iters
        rows.append({"kernel": label, "ms": ms,
                     "launches": launches,
                     "tera_ops_per_s": (ops * launches / (ms * 1e-3) / 1e12
                                        if ops else None)})
    rows.sort(key=lambda r: -r["ms"])
    device_ms = sum(r["ms"] for r in rows)
    for r in rows:
        r["share"] = r["ms"] / device_ms
    # busy share over the profiled forwards themselves: device time over
    # their own wall, so the profiler's overhead is in both
    return {"batch": batch, "layers": layers, "tokens_padded": S,
            "wall_ms": wall_ms, "device_ms": device_ms,
            "busy_share": device_ms / profiled_ms, "kernels": rows}


def stage_costs(encoder, cohort: Path, rgb_cohort: Path, n: int) -> dict:
    from emr2a_tpu_torch.data.images import load_image_rgb, resize_to

    spec = encoder.preprocess
    out, decoded = {}, {}
    for name, root in (("grey", cohort), ("rgb", rgb_cohort)):
        paths = sorted(root.rglob("*.png"))[:n]
        t0 = time.perf_counter()
        decoded[name] = [load_image_rgb(p) for p in paths]
        out[f"decode_{name}_ms"] = (time.perf_counter() - t0) * 1e3 / len(paths)
    decoded = decoded["grey"]
    t0 = time.perf_counter()
    canon = [resize_to(img, spec.resize_size, shortest_edge=spec.shortest_edge,
                       method=spec.method) for img in decoded]
    out["resize_ms"] = (time.perf_counter() - t0) * 1e3 / len(decoded)
    stack = np.stack(canon[:32])
    for _ in range(3):
        encoder._image_forward(stack)
    t0 = time.perf_counter()
    reps = 10
    for _ in range(reps):
        encoder._image_forward(stack)
    out["device_path_ms"] = (time.perf_counter() - t0) * 1e3 / (reps * len(stack))
    return out


def step2_wall(encoder, manifest_path: Path) -> dict:
    from emr2a_tpu_torch.pipelines.step2_embeddings import build_embeddings as step2

    image_paths = step2.load_images(step2.load_manifest(manifest_path),
                                    manifest_path.parent)
    n = sum(len(p) for p in image_paths.values())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    embeddings = step2.encode_images(encoder, image_paths, batch_size=32)
    wall = time.perf_counter() - t0
    if sum(len(e) for e in embeddings.values()) != n:
        raise RuntimeError("step2 dropped slices")
    return {"slices": n, "wall_s": wall, "slices_per_s": n / wall}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--fast", choices=["bf16", "int8"], default="bf16",
                        help="the tower's kernel path (default bf16)")
    parser.add_argument("--out", type=Path)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    card = card.splitlines()[0]
    print(f"card: {card}", flush=True)

    from emr2a_tpu_torch.encoders.biomedclip_encoder import BioMedCLIPEncoder
    from emr2a_tpu_torch.tools.cohort import write_cohort

    encoder = BioMedCLIPEncoder.random_init(
        seed=0, fast="int8" if args.fast == "int8" else True, device="cuda")
    result = {"card": card, "fast": args.fast, "tower": [], "iters": ITERS}
    for batch in BATCHES:
        prof = profile_tower(encoder, batch, ITERS)
        result["tower"].append(prof)
        print(f"tower {args.fast} batch {batch}: wall {prof['wall_ms']:.3f} ms/forward, "
              f"device {prof['device_ms']:.3f} ms/forward, busy share "
              f"{prof['busy_share']:.3f} ({card})", flush=True)
        for r in prof["kernels"]:
            rate = ("" if r["tera_ops_per_s"] is None
                    else f", {r['tera_ops_per_s']:.1f} TOP/s")
            print(f"  {r['ms']:.3f} ms ({r['share']:.1%}, {r['launches']:g} "
                  f"launches){rate}  {r['kernel']}", flush=True)

    with tempfile.TemporaryDirectory(prefix="profile_tower_") as tmp:
        grey = write_cohort(Path(tmp) / "grey", *COHORT)
        rgb = write_cohort(Path(tmp) / "rgb", *COHORT, rgb=True)
        stages = stage_costs(encoder, grey.parent, rgb.parent, n=64)
        result["stages_ms_per_slice"] = stages
        print("per slice: " + ", ".join(f"{k} {v:.3f}" for k, v in
                                        stages.items()) + f" ({card})",
              flush=True)
        result["step2"] = {}
        for name, manifest in (("grey", grey), ("rgb", rgb)):
            e2e = step2_wall(encoder, manifest)
            result["step2"][name] = e2e
            print(f"step2 {name} PNGs: {e2e['slices']} slices in "
                  f"{e2e['wall_s']:.3f} s, {e2e['slices_per_s']:.1f} slices/s "
                  f"({card})", flush=True)

    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
