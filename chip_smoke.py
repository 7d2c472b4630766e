"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) if it fails:

1. Require a CUDA device; print the card's name and power limit.
2. Build the hand-written kernels from ``emr2a_tpu_torch/csrc``.
3. Kernels, each against its plain PyTorch version at the main path's
   shapes, with median times over 100 launches (CUDA events): K1 (fused
   LN+MLP) and K3 (fused LN+attention) at BioMedCLIP ViT-B/16 batch 32; K2
   and K4 (their W8A8 variants) at the same shapes; K5 (W8A8 linear) at the
   PubMedBERT shapes (T = 32 x 256: 768->768, 768->3072, 3072->768) and at
   T = 32. The W8A8 kernels are also timed against a plain int8 yardstick
   (their plain versions with ``torch._int_mm`` products). K6 (the fused
   cosine top-k) at 1M x 512, k = 5, q = 1 and 64, in f32, bf16 and int8
   (int8 bit for bit; f32 and bf16 values within 1e-5, indices equal up to
   near-ties), beside a library yardstick (``torch.topk(q @ db.T)``; for
   int8 at q = 64 ``torch._int_mm`` + rescale + ``torch.topk``).
4. Main path, bf16: a synthetic CT cohort (PNG slices + manifest.jsonl)
   through the step2 functions with
   ``BioMedCLIPEncoder.random_init(fast=True)`` at full ViT-B/16 width;
   checks the artifacts, that every block of every device batch went
   through K1 and K3, and that the first slices' embeddings agree with the
   f32 plain tower on the CPU.
5. Main path, int8: the same cohort with ``random_init(fast="int8")``;
   every block of every device batch through K2 and K4, the same checks.
6. Text: ``encode_batch_texts`` of the int8 encoder's PubMedBERT tower
   (full width, context 256, a stub character tokenizer) on synthetic
   clinical texts; every quantized projection through K5; the embeddings
   of 8 texts against the same tower's plain int8 version on the CPU.
7. Retrieval: per-patient mean embeddings through the port's cosine top-k.
8. Database: ``database_cli`` build + query of the bf16 step2 embeddings
   in f32, bf16 and int8, on the card and with ``--cpu``, hits compared;
   ``use_pallas=True`` f32/bf16 on a padded buffer; the launch counts show
   K6 (int8 queries, use_pallas). Then the single-query p50 of
   ``topk_chained`` (256 scans, CUDA events) on a seeded 1M x 512 database
   in each dtype, f32/bf16 with use_pallas off and on.
9. CV: ``run_cv_experiments`` from a combined_embeddings.npz, on the card
   and with ``--device cpu``: the cohort (bf16 step2 slice means, int8
   text tower rows, concat, 3 folds) and a seeded 4-class set of 1,000
   patients (512-wide, 5 folds, PCA 96, concat, and late fusion at w_text
   0.3); folds, neighbours and confusion matrices identical, scores within
   1e-5.
10. Throughput of the bf16 and the int8 tower at batch 128, in turns.

Every kernel record carries its bound (the larger of its bytes over 3.35
TB/s and its operations over the card's peak for their type). The line
before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch


# H100 SXM peaks (NVIDIA's data sheet, dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
K6_N, K6_DIM, K6_K = 1_000_000, 512, 5


def bound(nbytes: float, ops=()) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the peak of their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = sum(n / PEAK_OPS_PER_S[kind] for kind, n in ops)
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def ptxas_summary(log: str) -> str:
    """One line per kernel of nvcc's ``-Xptxas -v`` report: registers,
    shared memory and spills."""
    lines, name, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spill = m.group(1), ""
        elif name and "bytes spill" in line:
            spill = line.split(":", 1)[-1].strip()
        elif name and "Used" in line:
            lines.append(f"ptxas {name}: {line.split(':', 1)[-1].strip()}; {spill}")
            name = None
    return "\n".join(sorted(set(lines)))


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


def int_mm_version(module, fn, weights):
    """``fn`` (a W8A8 op's plain version in ``module``) with its s8
    products on ``torch._int_mm`` (cuBLAS int8), as a yardstick only."""
    col_major = {w.data_ptr(): w.t().contiguous().t() for w in weights}

    def run():
        plain = module.s8_matmul
        module.s8_matmul = lambda q, w: torch._int_mm(q, col_major[w.data_ptr()]).float()
        try:
            return fn()
        finally:
            module.s8_matmul = plain
    return run


def quantize_weight(w: torch.Tensor):
    from emr2a_tpu_torch.ops.mlp import quantize_weight_int8
    q, s = quantize_weight_int8(w.float().cpu().numpy())
    return (torch.from_numpy(q).cuda(), torch.from_numpy(s.reshape(-1)).cuda())


def kernel_phase(card: str) -> list:
    from emr2a_tpu_torch.ops import attention_block, linear_int8, mlp, quant

    g = torch.Generator(device="cuda").manual_seed(0)

    def rn(*shape, std=1.0):
        return (torch.randn(*shape, generator=g, device="cuda") * std).to(torch.bfloat16)

    B, S, d, m, H, valid_len = 32, 200, 768, 3072, 12, 197
    x = rn(B, S, d)
    ln_s, ln_b = (1.0 + rn(d, std=0.1).float()).to(torch.bfloat16), rn(d, std=0.1)
    w1, b1, w2, b2 = rn(d, m, std=0.02), rn(m, std=0.02), rn(m, d, std=0.02), rn(d, std=0.02)
    attn_w = [rn(d, d, std=0.02) if i % 2 == 0 else rn(d, std=0.02) for i in range(8)]
    x2 = x.reshape(B * S, d)
    # W8A8 weights quantized from the same bf16 values, as fast="int8" does
    (w1q, w1s), (w2q, w2s) = quantize_weight(w1), quantize_weight(w2)
    attn_q = []
    for i in (0, 2, 4, 6):
        attn_q += [*quantize_weight(attn_w[i]), attn_w[i + 1]]
    mlp8 = (x2, ln_s, ln_b, w1q, w1s, b1, w2q, w2s, b2)

    k1 = lambda: mlp.fused_ln_mlp(x2, ln_s, ln_b, w1, b1, w2, b2)
    k1_ref = lambda: mlp.fused_ln_mlp_reference(x2, ln_s, ln_b, w1, b1, w2, b2)
    k3 = lambda: attention_block.fused_ln_attention(
        x, ln_s, ln_b, *attn_w, num_heads=H, valid_len=valid_len)
    k3_ref = lambda: attention_block.fused_ln_attention_reference(
        x, ln_s, ln_b, *attn_w, num_heads=H, valid_len=valid_len)
    k2 = lambda: mlp.fused_ln_mlp_int8(*mlp8)
    k2_ref = lambda: mlp.fused_ln_mlp_int8_reference(*mlp8)
    k4 = lambda: attention_block.fused_ln_attention_int8(
        x, ln_s, ln_b, *attn_q, num_heads=H, valid_len=valid_len)
    k4_ref = lambda: attention_block.fused_ln_attention_int8_reference(
        x, ln_s, ln_b, *attn_q, num_heads=H, valid_len=valid_len)
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

    vit = f"({B}, {S}, {d}), valid_len {valid_len}"
    T = B * S
    mlp_ops = 4 * T * d * m
    attn_ops = (8 * T * d * d, 4 * B * H * S * valid_len * (d // H))
    out_bytes = T * d * 2
    cases = [
        ("fused_ln_mlp", k1, k1_ref, {"plain_bf16_ms": k1_bf16}, "mlp.cu",
         "emr2a_tpu/ops/mlp.py:75", slice(None), f"T={T}, {d}->{m}->{d}",
         bound(nbytes(x2, ln_s, ln_b, w1, b1, w2, b2) + out_bytes,
               [("bf16", mlp_ops)])),
        ("fused_ln_attention", k3, k3_ref, {"plain_bf16_ms": k3_bf16},
         "attention_block.cu", "emr2a_tpu/ops/attention_block.py:270",
         slice(0, valid_len), vit,
         bound(nbytes(x, ln_s, ln_b, *attn_w) + out_bytes,
               [("bf16", attn_ops[0] + attn_ops[1])])),
        ("fused_ln_mlp_int8", k2, k2_ref,
         {"int_mm_ms": int_mm_version(mlp, k2_ref, (w1q, w2q))}, "mlp_int8.cu",
         "emr2a_tpu/ops/mlp.py:194", slice(None), f"T={T}, {d}->{m}->{d}",
         bound(nbytes(*mlp8) + out_bytes, [("int8", mlp_ops)])),
        ("fused_ln_attention_int8", k4, k4_ref,
         {"int_mm_ms": int_mm_version(attention_block, k4_ref, attn_q[0::3])},
         "attention_block_int8.cu", "emr2a_tpu/ops/attention_block.py:436",
         slice(0, valid_len), vit,
         bound(nbytes(x, ln_s, ln_b, *attn_q) + out_bytes,
               [("int8", attn_ops[0]), ("bf16", attn_ops[1])])),
    ]
    records = []
    for name, fn, ref, others, source, replaces, rows, shape, bnd in cases:
        got = fn()
        torch.cuda.synchronize()
        want = ref()
        got, want = (t.reshape(B, S, d)[:, rows] for t in (got, want))
        err = compare(name, got, want)
        rec = {"name": name, "route": "cuda",
               "source": f"emr2a_tpu_torch/csrc/{source}", "replaces": replaces,
               "shape": shape, "max_abs_err": err, "ms": median_ms(fn),
               "plain_ms": median_ms(ref), **bnd, "library_ms": None}
        rec.update({key: median_ms(f) for key, f in others.items()})
        print(f"{name}: kernel {rec['ms']:.4f} ms, plain version "
              f"{rec['plain_ms']:.4f} ms, " + ", ".join(
                  f"{key[:-3]} {rec[key]:.4f} ms" for key in others)
              + f" (median of 100, {shape}; {card})", flush=True)
        records.append(rec)

    # K5 at the PubMedBERT shapes (T = 32 texts x 256 tokens) and at T = 32
    shapes = []
    for T, K, N in ((32 * 256, 768, 768), (32 * 256, 768, 3072),
                    (32 * 256, 3072, 768), (32, 768, 3072)):
        xt = rn(T, K)
        wq, ws = quantize_weight(rn(K, N, std=0.02))
        bias = rn(N, std=0.02)
        fn = lambda: linear_int8.linear_w8a8(xt, wq, ws, bias)
        ref = lambda: linear_int8.linear_w8a8_reference(xt, wq, ws, bias)
        got = fn()
        torch.cuda.synchronize()
        err = compare(f"linear_w8a8 T={T} {K}->{N}", got, ref())
        if not torch.equal(got, ref()):
            fail(f"linear_w8a8 T={T} {K}->{N}: not bit-identical to its plain version")
        xq, _ = quant.quantize_rows_s8_reference(xt)
        w_cm = wq.t().contiguous().t()
        shape = {"shape": f"T={T}, {K}->{N}", "max_abs_err": err,
                 "ms": median_ms(fn), "plain_ms": median_ms(ref),
                 **bound(nbytes(xt, wq, ws, bias) + T * N * 2, [("int8", 2 * T * K * N)]),
                 "library_ms": None,
                 "int_mm_ms": median_ms(int_mm_version(linear_int8, ref, (wq,))),
                 "int_mm_product_ms": median_ms(lambda: torch._int_mm(xq, w_cm))}
        print(f"linear_w8a8 T={T} {K}->{N}: kernel {shape['ms']:.4f} ms, plain "
              f"version {shape['plain_ms']:.4f} ms, int_mm {shape['int_mm_ms']:.4f} ms, "
              f"the int_mm product alone {shape['int_mm_product_ms']:.4f} ms "
              f"(median of 100; {card})", flush=True)
        shapes.append(shape)
    head = shapes[1]
    records.append({"name": "linear_w8a8", "route": "cuda",
                    "source": "emr2a_tpu_torch/csrc/linear_int8.cu",
                    "replaces": "emr2a_tpu/ops/linear_int8.py:148",
                    **head, "max_abs_err": max(s["max_abs_err"] for s in shapes),
                    "shapes": shapes})

    # the shared row quantize: codes and scales equal the plain version's
    for xq in (x2, torch.randn(B * S, m, generator=g, device="cuda")):
        q, s = quant.quantize_rows_s8(xq)
        want_q, want_s = quant.quantize_rows_s8_reference(xq)
        if not (torch.equal(q, want_q) and torch.equal(s, want_s)):
            fail(f"quantize_rows_s8 ({xq.dtype}): codes differ from the plain version")
    print("quantize_rows_s8: codes and scales bit-identical to the plain "
          "version (bf16 and f32 rows)", flush=True)
    return records


def reset_counts() -> None:
    from emr2a_tpu_torch.ops import attention_block, linear_int8, mlp, quant, topk
    mlp.LAUNCHES = mlp.INT8_LAUNCHES = 0
    attention_block.LAUNCHES = attention_block.INT8_LAUNCHES = 0
    linear_int8.LAUNCHES = quant.LAUNCHES = 0
    topk.LAUNCHES = topk.INT8_LAUNCHES = 0


def read_counts() -> dict:
    from emr2a_tpu_torch.ops import attention_block, linear_int8, mlp, topk
    return {"fused_ln_mlp": mlp.LAUNCHES,
            "fused_ln_attention": attention_block.LAUNCHES,
            "fused_ln_mlp_int8": mlp.INT8_LAUNCHES,
            "fused_ln_attention_int8": attention_block.INT8_LAUNCHES,
            "linear_w8a8": linear_int8.LAUNCHES,
            "cosine_topk_fused": topk.LAUNCHES,
            "cosine_topk_fused_int8": topk.INT8_LAUNCHES}


def check_full_width(encoder) -> None:
    trunk = encoder.image_model.trunk
    bert = encoder.text_model.bert
    if not (trunk.config.hidden_size == 768 and len(trunk.blocks) == 12
            and trunk.config.num_heads == 12 and trunk.config.mlp_dim == 3072
            and encoder.config.projection_dim == 512):
        fail("the encoder is not BioMedCLIP ViT-B/16 at full width")
    cfg = bert.config
    if not (cfg.vocab_size == 30522 and cfg.hidden_size == 768
            and len(bert.blocks) == 12 and cfg.mlp_dim == 3072
            and encoder.context_length == 256):
        fail("the text tower is not PubMedBERT-256 at full width")


def step2_phase(tag: str, encoder, image_paths: dict, out_dir: Path,
                kernels: tuple, plain_cpu) -> dict:
    """Drive step2 with ``encoder``; check the artifacts, that every block
    of every device batch launched each of ``kernels`` and no other
    kernel, and the first 8 slices against the f32 plain CPU tower."""
    from emr2a_tpu_torch.pipelines.step2_embeddings import build_embeddings as step2

    device_batches = []
    hook = encoder.image_model.register_forward_hook(
        lambda mod, args, out: device_batches.append(args[0].shape[0]))
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.time()
    embeddings = step2.encode_images(encoder, image_paths, batch_size=32)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = read_counts()
    hook.remove()
    step2.save_embeddings(embeddings, out_dir)
    n_slices = sum(len(p) for p in image_paths.values())
    print(f"step2 {tag}: {len(embeddings)} patients, {n_slices} slices, "
          f"{len(device_batches)} device batches in {wall:.2f} s (host decode "
          f"included); launches {launches}", flush=True)

    if len(device_batches) != 12 * 2:
        fail(f"{tag}: expected 24 device batches (12 patients x 40 slices at "
             f"batch 32), got {len(device_batches)}")
    expected = 12 * len(device_batches)
    for name, n in launches.items():
        want = expected if name in kernels else 0
        if n != want:
            fail(f"{tag}: {name} launched {n} times, expected {want}")

    npz = np.load(out_dir / "embeddings.npz")
    meta = json.loads((out_dir / "embeddings_meta.json").read_text())
    if sorted(npz.files) != sorted(image_paths) or meta["embedding_dim"] != 512:
        fail(f"{tag} artifacts: patients {npz.files}, meta {meta}")
    for pid in npz.files:
        e = npz[pid]
        if e.shape != (40, 512) or e.dtype != np.float32 or not np.isfinite(e).all():
            fail(f"{tag} {pid}: embeddings {e.shape} {e.dtype}, "
                 f"finite={np.isfinite(e).all()}")
        norms = np.linalg.norm(e, axis=-1)
        if np.abs(norms - 1).max() > 1e-4:
            fail(f"{tag} {pid}: row norms {norms.min()}..{norms.max()}")

    first = image_paths[npz.files[0]][:8]
    want = plain_cpu.encode_images(first)
    cos = cosines(npz[npz.files[0]][:8], want)
    print(f"{tag} kernel path vs f32 plain CPU tower, 8 slices: min cosine "
          f"{cos.min():.6f}", flush=True)
    if cos.min() < 0.999:
        fail(f"{tag} embeddings disagree with the f32 plain tower: cosine {cos}")
    return {"npz": npz, "launches": launches}


def cosines(a, b) -> np.ndarray:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


class CharTokenizer:
    """A stub PubMedBERT tokenizer: [CLS] = 2, one id per character,
    [SEP] = 3, padding 0 up to ``max_length``. Nothing is downloaded."""

    def __call__(self, texts, max_length=256, **kw):
        ids = np.zeros((len(texts), max_length), np.int64)
        for i, t in enumerate(texts):
            toks = [2] + [4 + ord(c) % 30000 for c in t[:max_length - 2]] + [3]
            ids[i, :len(toks)] = toks
        return {"input_ids": ids, "attention_mask": (ids != 0).astype(np.int64)}


def clinical_texts(n: int) -> list:
    """Synthetic texts in the form of ``render_clinical_text`` (sex, age,
    fever, symptoms), some long enough to be truncated at 256 tokens."""
    rng = np.random.RandomState(7)
    symptoms = ["咳嗽", "气促", "胸痛", "乏力", "咳痰", "呼吸困难", "发热伴寒战"]
    out = []
    for i in range(n):
        parts = [f"性别: {'男' if i % 2 else '女'}", f"年龄: {20 + 3 * i % 70}",
                 f"发烧: {'是' if rng.rand() < 0.6 else '否'}",
                 "症状: " + "、".join(rng.choice(symptoms, 1 + i % 4, replace=False))]
        if i % 9 == 0:
            parts.append("病史: " + "双肺磨玻璃影，" * (10 + i))
        out.append("\n".join(parts))
    return out


def text_phase(encoder, plain_cpu, int8_cpu, card: str) -> dict:
    """encode_batch_texts on the int8 encoder: every quantized projection of
    every text batch through K5; 8 texts against the same int8 tower's
    plain version on the CPU (and, printed, the f32 tower)."""
    from emr2a_tpu_torch.models.layers import Int8Dense

    texts = clinical_texts(64)
    n_int8 = sum(isinstance(mod, Int8Dense) for mod in encoder.text_model.modules())
    batches = -(-len(texts) // encoder.max_batch)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.time()
    got = np.stack(encoder.encode_batch_texts(texts))
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = read_counts()
    print(f"text: {len(texts)} texts in {batches} batches of at most "
          f"{encoder.max_batch} x 256 tokens, {wall:.2f} s; {n_int8} int8 "
          f"projections; launches {launches}", flush=True)
    if n_int8 != 6 * 12:
        fail(f"text tower has {n_int8} int8 projections, expected 72")
    for name, n in launches.items():
        want = n_int8 * batches if name == "linear_w8a8" else 0
        if n != want:
            fail(f"text: {name} launched {n} times, expected {want}")
    if got.shape != (64, 512) or not np.isfinite(got).all():
        fail(f"text embeddings {got.shape}, finite={np.isfinite(got).all()}")
    if np.abs(np.linalg.norm(got, axis=-1) - 1).max() > 1e-4:
        fail("text embeddings are not unit rows")
    sample = texts[:8]
    cos = cosines(got[:8], np.stack(int8_cpu.encode_batch_texts(sample)))
    cos_f32 = cosines(got[:8], np.stack(plain_cpu.encode_batch_texts(sample)))
    print(f"text int8 kernel path, 8 texts: min cosine {cos.min():.6f} vs the "
          f"int8 plain version on the CPU, {cos_f32.min():.6f} vs the f32 "
          f"tower", flush=True)
    if cos.min() < 0.999:
        fail(f"text embeddings disagree with the int8 plain version: {cos}")
    return {"launches": launches}


def retrieval_phase(npz) -> None:
    from emr2a_tpu_torch.ops.topk import cosine_topk

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


def topk_agrees(name: str, got, want, scores, tol: float = 1e-5) -> float:
    """Values within tol; an index may differ from the plain version's only
    where the plain scores of the two rows lie within tol of each other.
    Returns the max abs error of the values."""
    (gv, gi), (wv, wi) = got, want
    err = (gv - wv).abs().max().item()
    if not torch.isfinite(gv).all() or err > tol:
        fail(f"{name}: values differ from the plain version by {err}")
    diff = gi != wi
    if diff.any():
        picked = scores[diff.nonzero()[:, 0], gi[diff].long()]
        gap = (picked - wv[diff]).abs().max().item()
        if gap > tol:
            fail(f"{name}: {int(diff.sum())} indices differ, not near-ties ({gap})")
    print(f"{name}: max_abs_err {err}, {int(diff.sum())} indices differ on "
          f"near-ties", flush=True)
    return err


def topk_kernel_phase(card: str) -> list:
    """K6 at 1M x 512, k = 5, q = 1 and 64, each storage type, against its
    plain version and a library yardstick."""
    from emr2a_tpu_torch.ops import topk

    g = torch.Generator(device="cuda").manual_seed(6)
    unit = lambda *shape: torch.nn.functional.normalize(
        torch.randn(*shape, generator=g, device="cuda"), dim=-1)
    db32 = unit(K6_N, K6_DIM)
    queries64 = unit(64, K6_DIM)
    # int8 rows: the DB's recipe (retrieval/database.quantize_rows_int8)
    amax = db32.abs().amax(dim=1)
    scales = amax / torch.full_like(amax, 127.0)
    scales = torch.where(scales == 0, torch.ones_like(scales), scales)
    codes = torch.clamp(torch.round(db32 / scales[:, None]), -127, 127).to(torch.int8)
    stores = {"f32": db32, "bf16": db32.to(torch.bfloat16)}
    shapes = {"cosine_topk_fused": [], "cosine_topk_fused_int8": []}
    for dtype in ("f32", "bf16", "int8"):
        for q in (1, 64):
            queries = queries64[:q].contiguous()
            ops = 2 * q * K6_N * K6_DIM
            out_bytes = q * K6_K * 8
            if dtype == "int8":
                fn = lambda: topk.cosine_topk_fused_int8(queries, codes, scales, K6_K)
                ref = lambda: topk.cosine_topk_fused_int8_reference(
                    queries, codes, scales, K6_K)

                def lib():
                    qc, qs = topk.quantize_queries_int8(queries)
                    s32 = torch._int_mm(qc, codes.t())
                    return torch.topk(s32.float() * qs[:, None] * scales[None, :], K6_K)
                library = lib if q > 16 else None   # _int_mm needs m > 16
                bnd = bound(nbytes(codes, scales, queries) + out_bytes, [("int8", ops)])
            else:
                db = stores[dtype]
                qs_ = queries.to(db.dtype)
                fn = lambda: topk.cosine_topk_fused(queries, db, K6_K)
                ref = lambda: topk.cosine_topk_fused_reference(queries, db, K6_K)
                library = lambda: torch.topk(qs_ @ db.T, K6_K)
                bnd = bound(nbytes(db, qs_) + out_bytes, [(dtype, ops)])
            name = f"cosine_topk_fused{'_int8' if dtype == 'int8' else ''}"
            got = fn()
            torch.cuda.synchronize()
            want = ref()
            tag = f"{name} {dtype} q={q}"
            if dtype == "int8":
                if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                    fail(f"{tag}: not bit-identical to its plain version")
                err = 0.0
                print(f"{tag}: bit-identical to its plain version", flush=True)
            else:
                scores = queries.to(stores[dtype].dtype).float() @ stores[dtype].float().T
                err = topk_agrees(tag, got, want, scores)
                del scores
            rec = {"shape": f"{dtype}, q={q}, n={K6_N}, dim={K6_DIM}, k={K6_K}",
                   "max_abs_err": err, "ms": median_ms(fn), "plain_ms": median_ms(ref),
                   **bnd, "library_ms": median_ms(library) if library else None}
            print(f"{tag}: kernel {rec['ms']:.4f} ms, plain version "
                  f"{rec['plain_ms']:.4f} ms, library "
                  + (f"{rec['library_ms']:.4f} ms" if library else "none")
                  + f", bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}) "
                  f"(median of 100; {card})", flush=True)
            shapes[name].append(rec)
            torch.cuda.empty_cache()
    records = []
    for name, recs in shapes.items():
        records.append({"name": name, "route": "cuda",
                        "source": "emr2a_tpu_torch/csrc/topk.cu",
                        "replaces": "emr2a_tpu/ops/topk.py:155", **recs[0],
                        "max_abs_err": max(r["max_abs_err"] for r in recs),
                        "shapes": recs})
    del db32, stores, codes
    torch.cuda.empty_cache()
    return records


def hits_agree(tag: str, card_rows: list, cpu_rows: list, tol: float) -> None:
    """Indices, labels and ids identical up to near-ties (a swap of two hits
    whose CPU scores lie within tol, or a last hit replaced by one within
    tol); scores within tol."""
    if [r["query_id"] for r in card_rows] != [r["query_id"] for r in cpu_rows]:
        fail(f"{tag}: query ids differ")
    ties = 0
    for a, b in zip(card_rows, cpu_rows):
        ga, gb = a["hits"], b["hits"]
        if len(ga) != len(gb):
            fail(f"{tag}: {a['query_id']} has {len(ga)} hits on the card, {len(gb)} on the CPU")
        cpu_score = {h["index"]: h["score"] for h in gb}
        for j, (ha, hb) in enumerate(zip(ga, gb)):
            if abs(ha["score"] - hb["score"]) > tol:
                fail(f"{tag}: {a['query_id']} hit {j} score {ha['score']} vs {hb['score']}")
            if ha != {**hb, "score": ha["score"]}:
                ties += 1
                other = cpu_score.get(ha["index"])
                if other is None and j < len(ga) - 1 or \
                        other is not None and abs(other - hb["score"]) > tol:
                    fail(f"{tag}: {a['query_id']} hit {j}: {ha} on the card, {hb} on the CPU")
    print(f"{tag}: card and CPU hits agree ({len(card_rows)} queries, {ties} "
          f"near-tie swaps, scores within {tol})", flush=True)


def database_phase(work: Path, emb_path: Path, manifest_path: Path) -> dict:
    """database_cli build + query on the card and on the CPU in each dtype;
    use_pallas f32/bf16 on a padded buffer. Returns the launch counts."""
    from emr2a_tpu_torch.retrieval import database_cli
    from emr2a_tpu_torch.retrieval.database import ShardedEmbeddingDatabase

    torch.cuda.synchronize()
    reset_counts()
    hits = {}
    for dtype in ("f32", "bf16", "int8"):
        for dev in ("cuda", "cpu"):
            d = work / "db" / f"{dtype}_{dev}"
            flag = ["--cpu"] if dev == "cpu" else []
            database_cli.main(["build", "--embeddings_path", str(emb_path),
                               "--manifest_path", str(manifest_path),
                               "--db", str(d / "db.npz"), "--dtype", dtype, *flag])
            database_cli.main(["query", "--db", str(d / "db.npz"), "--queries_path",
                               str(emb_path), "--k", "5", "--dtype", dtype,
                               "--output", str(d / "hits.jsonl"), *flag])
            hits[dtype, dev] = [json.loads(line) for line in
                                (d / "hits.jsonl").read_text().splitlines()]
    ids, mat = database_cli._load_cases(emb_path)
    for dtype, tdt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        db = ShardedEmbeddingDatabase(mat, ids=ids, dtype=tdt, use_pallas=True,
                                      capacity=len(ids) + 4, device="cuda")
        got = db.topk(mat, 5)
        db.use_pallas = False
        want = db.topk(mat, 5)
        scores = db._queries(mat, True).float() @ db.db[:db.n].float().T
        topk_agrees(f"database use_pallas {dtype} (padded buffer)", got, want, scores)
    torch.cuda.synchronize()
    launches = read_counts()
    print(f"database: launches {launches}", flush=True)
    for dtype, tol in (("f32", 1e-5), ("bf16", 1e-5), ("int8", 1e-3)):
        hits_agree(f"database_cli {dtype}", hits[dtype, "cuda"], hits[dtype, "cpu"], tol)
    for row in hits["f32", "cuda"]:
        if row["hits"][0]["patient_id"] != row["query_id"]:
            fail(f"database: {row['query_id']} did not retrieve itself first")
    want = {"cosine_topk_fused": 2, "cosine_topk_fused_int8": 1}
    for name, n in launches.items():
        if n != want.get(name, 0):
            fail(f"database: {name} launched {n} times, expected {want.get(name, 0)}")
    return launches


def p50_phase(card: str) -> None:
    """Single-query p50 of topk_chained (256 scans, CUDA events) on a
    seeded 1M x 512 database, each dtype; f32/bf16 with use_pallas off and
    on."""
    from emr2a_tpu_torch.retrieval.database import ShardedEmbeddingDatabase
    from emr2a_tpu_torch.retrieval.database_cli import chained_p50_ms

    rng = np.random.default_rng(0)
    emb = rng.standard_normal((K6_N, K6_DIM), dtype=np.float32)
    query = emb[123] + 0.1 * rng.standard_normal(K6_DIM, dtype=np.float32)
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16),
                        ("int8", torch.int8)):
        t0 = time.time()
        db = ShardedEmbeddingDatabase(emb, dtype=dtype, device="cuda")
        built = time.time() - t0
        for use_pallas in ((None,) if name == "int8" else (False, True)):
            db.use_pallas = bool(use_pallas)
            ms = chained_p50_ms(db, query, K6_K, 256)
            _, idx = db.topk_chained(query, K6_K, repeats=2)
            if int(idx[0, 0]) != 123:
                fail(f"p50 {name}: the query's source row is not its top hit")
            path = "K6 int8" if name == "int8" else ("K6" if use_pallas else "plain")
            print(f"database p50 {name} ({path}): {ms:.4f} ms/query (median of 3 "
                  f"runs of 256 chained scans, CUDA events; n={K6_N}, dim={K6_DIM}, "
                  f"k={K6_K}; built in {built:.1f} s; {card})", flush=True)
        del db
        torch.cuda.empty_cache()


def compare_cv(tag: str, exp_card: Path, exp_cpu: Path) -> None:
    folds = sorted(p.name for p in exp_cpu.glob("fold_*"))
    if not folds or folds != sorted(p.name for p in exp_card.glob("fold_*")):
        fail(f"cv {tag}: folds {folds}")
    worst = 0.0
    for fold in folds:
        a = json.loads((exp_card / fold / "metrics.json").read_text(encoding="utf-8"))
        b = json.loads((exp_cpu / fold / "metrics.json").read_text(encoding="utf-8"))
        if set(a) != set(b):
            fail(f"cv {tag} {fold}: keys differ")
        for key in b:
            if key == "all_top_scores":
                diff = np.abs(np.asarray(a[key]) - np.asarray(b[key])).max()
                worst = max(worst, float(diff))
                if diff > 1e-5:
                    fail(f"cv {tag} {fold}: scores differ by {diff}")
            elif a[key] != b[key]:
                fail(f"cv {tag} {fold}: {key} differs between card and CPU")
    if (exp_card / "summary.csv").read_text() != (exp_cpu / "summary.csv").read_text():
        fail(f"cv {tag}: summary.csv differs")
    print(f"cv {tag}: {len(folds)} folds identical on the card and the CPU "
          f"(scores within {worst:.2e})", flush=True)


def cv_phase(work: Path, bf16_npz, manifest_path: Path, text_encoder, card: str) -> None:
    """run_cv_experiments from a combined_embeddings.npz, on the card and
    with --device cpu: the cohort and a seeded 1,000-patient set."""
    from emr2a_tpu_torch.analysis import run_cv_experiments as runner
    from emr2a_tpu_torch.tools.cohort import LABELS

    cv = work / "cv"
    cv.mkdir()
    pids = sorted(bf16_npz.files)
    text = np.stack(text_encoder.encode_batch_texts(clinical_texts(len(pids))))
    np.savez_compressed(cv / "cohort.npz", patient_ids=np.asarray(pids),
                        image_matrix=np.stack([bf16_npz[p].mean(0) for p in pids]),
                        text_matrix=text)
    rng = np.random.RandomState(1)
    n = 1000
    labels = [LABELS[i % 4] for i in range(n)]
    centers = rng.randn(2, 4, 512)
    img = np.stack([centers[0, i % 4] + 8 * rng.randn(512) for i in range(n)])
    txt = np.stack([centers[1, i % 4] + 9 * rng.randn(512) for i in range(n)])
    synth_ids = [f"S{i:04d}" for i in range(n)]
    np.savez_compressed(cv / "synth.npz", patient_ids=np.asarray(synth_ids),
                        image_matrix=img.astype(np.float32),
                        text_matrix=txt.astype(np.float32))
    synth_manifest = cv / "synth_manifest.jsonl"
    synth_manifest.write_text("".join(
        json.dumps({"patient_id": p, "label": l}) + "\n"
        for p, l in zip(synth_ids, labels)), encoding="utf-8")
    runs = [("cohort", manifest_path, cv / "cohort.npz",
             ["--fusion", "concat", "--cv_folds", "3"]),
            ("synth_concat", synth_manifest, cv / "synth.npz",
             ["--fusion", "concat", "--cv_folds", "5", "--pca_dim", "96"]),
            ("synth_late", synth_manifest, cv / "synth.npz",
             ["--fusion", "late", "--w_text", "0.3", "--cv_folds", "5",
              "--pca_dim", "96"])]
    for tag, manifest, npz, extra in runs:
        walls = {}
        for dev in ("cuda", "cpu"):
            torch.cuda.synchronize()
            t0 = time.time()
            runner.main(["--manifest_path", str(manifest), "--output_dir",
                         str(cv / dev), "--experiment_id", tag, "--skip_encoding",
                         "--embeddings_path", str(npz), "--device", dev, *extra])
            torch.cuda.synchronize()
            walls[dev] = time.time() - t0
        compare_cv(tag, cv / "cuda" / f"exp_{tag}", cv / "cpu" / f"exp_{tag}")
        summary = (cv / "cuda" / f"exp_{tag}" / "summary.csv").read_text().splitlines()
        top1 = next(line for line in summary if line.startswith("top1,"))
        print(f"cv {tag}: wall {walls['cuda']:.2f} s with --device cuda, "
              f"{walls['cpu']:.2f} s with --device cpu (host clock, artifacts "
              f"included; {card}); {top1}", flush=True)


def throughput_phase(encoders: dict, card: str) -> None:
    """Each tower at batch 128 on the same pixels, in turns (bf16, int8,
    int8, bf16)."""
    from emr2a_tpu_torch.ops.preprocess import preprocess_images

    batch = torch.randint(0, 256, (128, 224, 224, 3), dtype=torch.uint8,
                          device="cuda",
                          generator=torch.Generator(device="cuda").manual_seed(1))
    with torch.inference_mode():
        pixels = preprocess_images(batch, encoders["bf16"].preprocess)
        for tag in ("bf16", "int8", "int8", "bf16"):
            ms = median_ms(lambda: encoders[tag].image_model(pixels), iters=30)
            print(f"tower throughput: {128 / ms * 1e3:.1f} slices/s at batch "
                  f"128, {tag} kernel path, median {ms:.3f} ms per batch "
                  f"({card})", flush=True)


def main_path_phase(work: Path, records: list, card: str) -> None:
    from emr2a_tpu_torch.encoders.biomedclip_encoder import BioMedCLIPEncoder
    from emr2a_tpu_torch.pipelines.step2_embeddings import build_embeddings as step2
    from emr2a_tpu_torch.tools.cohort import write_cohort

    t0 = time.time()
    manifest_path = write_cohort(work / "cohort")
    print(f"cohort written in {time.time() - t0:.1f} s", flush=True)
    image_paths = step2.load_images(step2.load_manifest(manifest_path), work)
    tok = CharTokenizer()
    t0 = time.time()
    plain_cpu = BioMedCLIPEncoder.random_init(seed=0, fast=False, device="cpu",
                                              tokenizer=tok)
    int8_cpu = BioMedCLIPEncoder.random_init(seed=0, fast="int8", device="cpu",
                                             tokenizer=tok)
    encoders = {
        "bf16": BioMedCLIPEncoder.random_init(seed=0, fast=True, device="cuda",
                                              tokenizer=tok),
        "int8": BioMedCLIPEncoder.random_init(seed=0, fast="int8", device="cuda",
                                              tokenizer=tok, max_batch=32)}
    print(f"encoders built (random weights, seed 0) in {time.time() - t0:.1f} s",
          flush=True)
    for enc in encoders.values():
        check_full_width(enc)

    bf16 = step2_phase("bf16", encoders["bf16"], image_paths, work / "bf16",
                       ("fused_ln_mlp", "fused_ln_attention"), plain_cpu)
    int8 = step2_phase("int8", encoders["int8"], image_paths, work / "int8",
                       ("fused_ln_mlp_int8", "fused_ln_attention_int8"), plain_cpu)
    text = text_phase(encoders["int8"], plain_cpu, int8_cpu, card)
    retrieval_phase(bf16["npz"])
    db = {"launches": database_phase(work, work / "bf16" / "embeddings.npz",
                                     manifest_path)}
    run_of = {"fused_ln_mlp": bf16, "fused_ln_attention": bf16,
              "fused_ln_mlp_int8": int8, "fused_ln_attention_int8": int8,
              "linear_w8a8": text, "cosine_topk_fused": db,
              "cosine_topk_fused_int8": db}
    for rec in records:
        rec["launches"] = run_of[rec["name"]]["launches"][rec["name"]]
    p50_phase(card)
    cv_phase(work, bf16["npz"], manifest_path, encoders["int8"], card)
    throughput_phase(encoders, card)


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
    print(ptxas_summary(lib.with_suffix(".log").read_text()), flush=True)

    records = kernel_phase(card) + topk_kernel_phase(card)
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
