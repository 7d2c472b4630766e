"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) if it fails:

1. Require a CUDA device; print the card's name and power limit.
2. Build the hand-written kernels from ``emr2a_tpu_torch/csrc``.
3. Kernels: K1 (fused LN+MLP) and K3 (fused LN+attention) against their
   plain PyTorch versions at the shapes of BioMedCLIP ViT-B/16 at batch 32,
   with median times over 100 launches (CUDA events).
4. Main path: a synthetic CT cohort (PNG slices + manifest.jsonl) through
   the step2 functions with ``BioMedCLIPEncoder.random_init(fast=True)`` at
   full ViT-B/16 width; checks the artifacts, that every block of every
   device batch went through both kernels, and that the first slices'
   embeddings agree with the f32 plain tower on the CPU.
5. Retrieval: per-patient mean embeddings through the port's cosine top-k.
6. Throughput of the bf16 tower at batch 128.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def median_ms(fn, iters: int = 100, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def compare(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """assert_close at atol = rtol = 1e-2 and per-row cosine >= 0.9999;
    returns the max abs error."""
    got = got.float().reshape(-1, got.shape[-1])
    want = want.float().reshape(-1, want.shape[-1])
    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite output")
    try:
        torch.testing.assert_close(got, want, atol=1e-2, rtol=1e-2)
    except AssertionError as e:
        fail(f"{name} disagrees with its plain version: {e}")
    cos = torch.nn.functional.cosine_similarity(got, want, dim=-1).min().item()
    if cos < 0.9999:
        fail(f"{name}: min row cosine {cos} < 0.9999")
    err = (got - want).abs().max().item()
    print(f"{name}: max_abs_err {err} min_row_cos {cos}", flush=True)
    return err


def kernel_phase(card: str) -> list:
    from emr2a_tpu_torch.ops import attention_block, mlp

    g = torch.Generator(device="cuda").manual_seed(0)

    def rn(*shape, std=1.0):
        return (torch.randn(*shape, generator=g, device="cuda") * std).to(torch.bfloat16)

    B, S, d, m, H, valid_len = 32, 200, 768, 3072, 12, 197
    x = rn(B, S, d)
    ln_s, ln_b = (1.0 + rn(d, std=0.1).float()).to(torch.bfloat16), rn(d, std=0.1)
    w1, b1, w2, b2 = rn(d, m, std=0.02), rn(m, std=0.02), rn(m, d, std=0.02), rn(d, std=0.02)
    attn_w = [rn(d, d, std=0.02) if i % 2 == 0 else rn(d, std=0.02) for i in range(8)]
    x2 = x.reshape(B * S, d)

    k1 = lambda: mlp.fused_ln_mlp(x2, ln_s, ln_b, w1, b1, w2, b2)
    k1_ref = lambda: mlp.fused_ln_mlp_reference(x2, ln_s, ln_b, w1, b1, w2, b2)
    k3 = lambda: attention_block.fused_ln_attention(
        x, ln_s, ln_b, *attn_w, num_heads=H, valid_len=valid_len)
    k3_ref = lambda: attention_block.fused_ln_attention_reference(
        x, ln_s, ln_b, *attn_w, num_heads=H, valid_len=valid_len)
    # plain bf16 PyTorch on the same shapes (cuBLAS bf16 products), for scale
    k1_bf16 = lambda: x2 + (mlp.gelu_tanh(torch.nn.functional.layer_norm(
        x2, (d,), ln_s, ln_b, 1e-6) @ w1 + b1) @ w2 + b2)

    def k3_bf16():
        h = torch.nn.functional.layer_norm(x, (d,), ln_s, ln_b, 1e-6)
        q, k, v = (h @ attn_w[i] + attn_w[i + 1] for i in (0, 2, 4))
        split = lambda t: t.reshape(B, S, H, d // H).transpose(1, 2)
        mask = torch.zeros(S, device="cuda", dtype=torch.bfloat16)
        mask[valid_len:] = float("-inf")
        o = torch.softmax(split(q) @ split(k).transpose(-1, -2) * (d // H) ** -0.5
                          + mask, dim=-1) @ split(v)
        return x + o.transpose(1, 2).reshape(B, S, d) @ attn_w[6] + attn_w[7]

    records = []
    for name, fn, ref, bf16, source, replaces, rows in (
            ("fused_ln_mlp", k1, k1_ref, k1_bf16, "emr2a_tpu_torch/csrc/mlp.cu",
             "emr2a_tpu/ops/mlp.py:75", slice(None)),
            ("fused_ln_attention", k3, k3_ref, k3_bf16,
             "emr2a_tpu_torch/csrc/attention_block.cu",
             "emr2a_tpu/ops/attention_block.py:270", slice(0, valid_len))):
        got = fn()
        torch.cuda.synchronize()
        want = ref()
        got, want = (t.reshape(B, S, d)[:, rows] for t in (got, want))
        err = compare(name, got, want)
        ms = median_ms(fn)
        plain_ms = median_ms(ref)
        plain_bf16_ms = median_ms(bf16)
        print(f"{name}: kernel {ms:.4f} ms, plain f32-product version "
              f"{plain_ms:.4f} ms, plain bf16 PyTorch {plain_bf16_ms:.4f} ms "
              f"(median of 100, {card})", flush=True)
        records.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "max_abs_err": err, "ms": ms,
                        "plain_ms": plain_ms, "plain_bf16_ms": plain_bf16_ms})
    return records


def main_path_phase(work: Path, records: list, card: str) -> None:
    from emr2a_tpu_torch.encoders.biomedclip_encoder import BioMedCLIPEncoder
    from emr2a_tpu_torch.ops import attention_block, mlp
    from emr2a_tpu_torch.ops.topk import cosine_topk
    from emr2a_tpu_torch.pipelines.step2_embeddings import build_embeddings as step2
    from emr2a_tpu_torch.tools.cohort import write_cohort

    t0 = time.time()
    manifest_path = write_cohort(work / "cohort")
    print(f"cohort written in {time.time() - t0:.1f} s", flush=True)
    encoder = BioMedCLIPEncoder.random_init(seed=0, fast=True, device="cuda")
    trunk = encoder.image_model.trunk
    if not (trunk.config.hidden_size == 768 and len(trunk.blocks) == 12
            and trunk.config.num_heads == 12 and trunk.config.mlp_dim == 3072
            and encoder.config.projection_dim == 512):
        fail("the encoder is not BioMedCLIP ViT-B/16 at full width")
    device_batches = []
    encoder.image_model.register_forward_hook(
        lambda mod, args, out: device_batches.append(args[0].shape[0]))

    manifest = step2.load_manifest(manifest_path)
    image_paths = step2.load_images(manifest, work)
    mlp.LAUNCHES = 0
    attention_block.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.time()
    embeddings = step2.encode_images(encoder, image_paths, batch_size=32)
    wall = time.time() - t0
    launches = {"fused_ln_mlp": mlp.LAUNCHES,
                "fused_ln_attention": attention_block.LAUNCHES}
    out_dir = work / "features"
    step2.save_embeddings(embeddings, out_dir)
    n_slices = sum(len(p) for p in image_paths.values())
    print(f"step2: {len(embeddings)} patients, {n_slices} slices, "
          f"{len(device_batches)} device batches in {wall:.2f} s (host decode "
          f"included); launches {launches}", flush=True)

    for rec in records:
        rec["launches"] = launches[rec["name"]]
    expected = 12 * len(device_batches)
    if len(device_batches) != 12 * 2:
        fail(f"expected 24 device batches (12 patients x 40 slices at batch "
             f"32), got {len(device_batches)}")
    for name, n in launches.items():
        if n != expected:
            fail(f"{name} launched {n} times, expected 12 x "
                 f"{len(device_batches)} = {expected}")

    npz = np.load(out_dir / "embeddings.npz")
    meta = json.loads((out_dir / "embeddings_meta.json").read_text())
    if sorted(npz.files) != sorted(image_paths) or meta["embedding_dim"] != 512:
        fail(f"artifacts: patients {npz.files}, meta {meta}")
    for pid in npz.files:
        e = npz[pid]
        if e.shape != (40, 512) or not np.isfinite(e).all():
            fail(f"{pid}: embeddings {e.shape}, finite={np.isfinite(e).all()}")
        norms = np.linalg.norm(e, axis=-1)
        if np.abs(norms - 1).max() > 1e-4:
            fail(f"{pid}: row norms {norms.min()}..{norms.max()}")

    # the first 8 slices against the f32 plain (unfused) tower on the CPU
    first = image_paths[npz.files[0]][:8]
    plain = BioMedCLIPEncoder.random_init(seed=0, fast=False, device="cpu")
    want = plain.encode_images(first)
    got = npz[npz.files[0]][:8]
    cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1)
                                  * np.linalg.norm(want, axis=-1))
    print(f"bf16 kernel path vs f32 plain CPU tower, 8 slices: min cosine "
          f"{cos.min():.6f}", flush=True)
    if cos.min() < 0.999:
        fail(f"embeddings disagree with the f32 plain tower: cosine {cos}")

    # retrieval on per-patient means
    pids = npz.files
    means = torch.tensor(np.stack([npz[p].mean(0) for p in pids]), device="cuda")
    _, idx = cosine_topk(means, means, k=5)
    if not (idx[:, 0].cpu() == torch.arange(len(pids))).all():
        fail(f"a patient did not retrieve itself first: {idx[:, 0].tolist()}")
    # and across halves: even slices query, odd slices form the database
    q = torch.tensor(np.stack([npz[p][0::2].mean(0) for p in pids]), device="cuda")
    db = torch.tensor(np.stack([npz[p][1::2].mean(0) for p in pids]), device="cuda")
    _, idx = cosine_topk(q, db, k=5)
    hits = (idx[:, 0].cpu() == torch.arange(len(pids))).float().mean().item()
    print(f"retrieval: every patient retrieves itself first; split-half "
          f"top-1 {hits:.3f} (random weights)", flush=True)

    # tower throughput, bf16 kernel path, batch 128
    from emr2a_tpu_torch.ops.preprocess import preprocess_images
    batch = torch.randint(0, 256, (128, 224, 224, 3), dtype=torch.uint8,
                          device="cuda",
                          generator=torch.Generator(device="cuda").manual_seed(1))
    with torch.inference_mode():
        pixels = preprocess_images(batch, encoder.preprocess)
        ms = median_ms(lambda: encoder.image_model(pixels), iters=30)
    print(f"tower throughput: {128 / ms * 1e3:.1f} slices/s at batch 128, "
          f"bf16 kernel path, median {ms:.3f} ms per batch ({card})",
          flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}", flush=True)

    from emr2a_tpu_torch.ops import _build
    t0 = time.time()
    lib = _build.build()
    _build.library()
    print(f"kernels built in {time.time() - t0:.1f} s: {lib.name}", flush=True)
    print(lib.with_suffix(".log").read_text().strip(), flush=True)

    records = kernel_phase(card)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        main_path_phase(Path(tmp), records, card)

    print(card)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
