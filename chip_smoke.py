"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) if it fails:

1. Require a CUDA device; print the card's name and power limit.
2. Build the hand-written kernels from ``emr2a_tpu_torch/csrc``; print
   ptxas's registers, shared memory and spills per kernel, and the
   attention core's residency (blocks and warps an SM).
3. Kernels, each against its plain PyTorch version at the main path's
   shapes, with median times over 100 launches (CUDA events): K1 (fused
   LN+MLP) and K2 (its W8A8 variant), each also with act_dtype=bf16, K3
   (fused LN+attention), K3m (its merged-batch schedule, block_b 4, bit
   for bit against K3) and K4 (its W8A8 variant) through
   ``tools/time_blocks.py`` at step2's batch of 32 (T = 6,400; (32, 200,
   768)), the layer breakdown's B = 96 and the tower's batch of 128 at S =
   197 (K2 at the first and the last, K1's and K2's bf16 gelu at the
   first two), single, chained and in a CUDA
   graph, with the device time by launch, beside plain bf16 PyTorch (K2
   and K4: their plain versions on ``torch._int_mm``) and the bound; K3m's
   group (from the card's SM count and L2 size), its device launches a call
   and its times beside K3's at each shape; K3
   and K4 at (2, 577, 768), valid_len 570, against their plain versions
   and K3m there, at (37, 200, 768) (groups 24 + 13) and at (3, 200,
   768) (B < block_b) bit for bit against K3; K5 (W8A8 linear) bit
   for bit at the PubMedBERT shapes (T = 32 x 256: 768->768, 768->3072,
   3072->768), at T = 32, and at the int8 judge's eight (T = 2048 and T = 1
   on 4096->4096, 4096->1024, 4096->12288, 12288->4096), each timed by
   ``tools/time_linears.py`` (single quartiles and chained) beside cuBLAS
   bf16 on the dequantized weight. K5 is also timed against a
   plain int8 yardstick (its plain version with ``torch._int_mm``
   products). K6 (the fused
   cosine top-k) at 1M x 512, k = 5, q = 1, 4, 8, 16, 32 and 64, in f32,
   bf16 and int8, on both of its scans (the streaming scan and the tile
   scan, forced in turn), and at k = 100, q = 64 (the tile scan), each
   against its plain version (int8 bit for bit; f32 and bf16 values within
   1e-5, indices equal up to near-ties), beside a library yardstick
   (``torch.topk(q @ db.T)``; for int8 at q > 16 ``torch._int_mm`` +
   rescale + ``torch.topk``); the crossover (the least q from which the
   tile scan is faster, chained, at every larger q) is printed beside the
   wrapper's. K6, K8 and K9 carry the median and quartiles of 100 single
   launches and the least of 3 chains of 20 back-to-back launches.
4. Main path, bf16: a synthetic CT cohort (PNG slices + manifest.jsonl)
   through the step2 functions with
   ``BioMedCLIPEncoder.random_init(fast=True)`` at full ViT-B/16 width;
   checks the artifacts, that every block of every device batch went
   through K1 and K3, and that the first slices' embeddings agree with the
   f32 plain tower on the CPU.
5. Main path, int8: the same cohort with ``random_init(fast="int8")``;
   every block of every device batch through K2 and K4, the same checks.
5b. The C++ decode pool (``emr2a_tpu_torch/native``, built with the host's
   g++ from the repo's sources, no libpng or libjpeg): the cohort's 480 grey
   PNGs, an rgb=True cohort of 2 patients and four JPEGs of its slices
   (baseline 4:2:0 and 4:4:4, progressive, grey) byte for byte against
   PIL's decode through ``resize_rgb_reference``, at 512 and 224; its
   slices/s at 224 on 1 thread and on every core beside the per-image host
   path and beside PIL's decode on a thread pool, with ``os.cpu_count()``
   and the affinity's cores. Then ``tools/step2_e2e``'s measurement with
   both encoders on the cohort regrouped into patients of 192 slices, at
   ``scripts/exp_step2_e2e.py``'s batch_size = max_batch = 96: with the
   pool (``assume_square_sources``) and without it (per-image host
   decode), and with the pool at batch_size 192 (two chunks a call,
   double-buffered): end-to-end and embed slices/s, each run's launches
   (every block on the precision's two kernels) and pool batches checked;
   the pool run's first chunk against the plain f32 and int8 towers on the
   CPU fed the same pool-decoded bytes (cosine 0.999), the double-buffered
   rows against the pool run's, pool against host-decode rows within
   cosine 0.99.
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
   in each dtype, f32/bf16 with use_pallas off and on, and a batched
   ``topk`` of 64 queries at k = 5 and k = 100 on it (use_pallas for
   f32/bf16), against the plain scan, whose launch counts must show K6's
   tile scan.
8b. The mesh on this card (``parallel.default_mesh()``: every visible card,
   one here): the database CLI (int8 build + query) on the default mesh,
   hits equal the database phase's; the sharded scan's own functions
   (``shard_topk`` per slab with its ``base`` and valid rows, then
   ``merge_topk``) over four slabs of a seeded 525k x 512 database on
   cuda:0, two full, one short and one empty, in f32, bf16 (K6) and int8
   (K6's int8 variant) at q = 1 and 64, k = 5 and 100, indices equal the
   one-device database's scan, values compared bit for bit, K6's launches
   read just after; step2's CLI ``--encoder_type vit --fast`` on 2
   patients with ``--data_parallel`` and without: every block on K1 and K3
   in both, rows equal. (Several cards: ``python -m
   emr2a_tpu_torch.tools.multichip_smoke``.)
8c. Processes (``parallel.initialize_distributed``, ``parallel.launch``):
   the database over two processes on this card, started by ``torchrun``
   (``tools/db_processes.py --case measure --one_card``: 1M x 512 seeded
   rows written once to a file each rank maps, one shard of them each, the
   candidates all-gathered over gloo, since NCCL takes one process a card)
   in f32, bf16 (K6) and int8; each rank's K6 launches (set to 0 before its
   searches, read after) and answers at q = 1 and 64, k = 5 and 100 against
   one process's database on this card, built here while the ranks run
   (indices equal, values bit for bit). (JAX's two-process worker case:
   the CPU tests; times over NCCL, one process a card: ``multichip_smoke
   --phases f``.)
9. CV: ``run_cv_experiments`` from a combined_embeddings.npz, on the card
   and with ``--device cpu``: the cohort (bf16 step2 slice means, int8
   text tower rows, concat, 3 folds) and a seeded 4-class set of 1,000
   patients (512-wide, 5 folds, PCA 96, concat, and late fusion at w_text
   0.3); folds, neighbours and confusion matrices identical, scores within
   1e-5.
10. Throughput of the bf16 and the int8 tower at batch 128, in turns.
11. Judge kernels: K7 (W4A8 linear) at the 8B's four projection shapes,
    T = 1 and T = 2048 (and T = 5 and 40, a speculative verify's token
    counts at B = 1 and at 8 slots), bit for bit against its plain version, timed as K5
    beside cuBLAS bf16 on the dequantized weight; the card's int8 and int4 weight
    quantizers against the numpy ones on a 4096 x 12288 matrix; K8 (per-frame
    vision attention) at (7, 1024, 16, 72) and K9 (the same kernel's second
    entry) at ViT-B (32, 197, 12, 64) against their plain versions
    (bf16: atol = rtol = 1e-2, row cosine >= 0.9999) and
    ``scaled_dot_product_attention``; K10 (the decoder's GQA decode
    attention over the bf16 KV cache) at the judge cells' shapes (32 / 8
    heads of 128, L = 2,240; B = 8 and 1 at S = 1, a verify's S = 5)
    through ``tools/time_decode_attention.py``: against its plain version
    under the same limits, two calls bit for bit, single, chained and
    graph times (one cache, and cycling over caches larger than the L2),
    the plain version and SDPA with ``enable_gqa`` as the yardstick.
12. Judge: Qwen3-VL-8B at full width (random weights, seed 0, on the card)
    in bf16, int8 and int4 (``QwenVLBackend``): one 7-image audit request
    of the cohort each, with every vision block on K8 and every decoder
    projection on K5 (int8) or K7 (int4), every decode step but the first
    replayed from a CUDA graph (the launch counts and decoder forwards
    include the replays); prefill time, decode ms a step eager and replayed
    from the graph from the same state (CUDA events; equal tokens, and one
    replayed step equal to the eager step bit for bit: KV cache, logits,
    tokens; K10 launched 36 times a step, eager and replayed, and 36 times
    each decoder forward of at most 16 positions of the request, none with
    the int8 KV cache), the kernel launches a token and the replayed steps'
    busy share (``torch.profiler``), and peak memory; the K5 / K7 calls of one more
    decode step and
    the device launches their kernel library issued for them: one GEMV
    launch a call, with no separate row quantize. Then the same weights cut to 2 vision blocks
    and 2 text layers, last-position prefill logits on the card against
    the plain versions on the CPU (cosine >= 0.9998 and max abs error <=
    0.2 in bf16, >= 0.997 and <= 0.75 in int8 and int4; the CPU's greedy
    token, or one tied with it there), limits that must refuse the card against the CPU's logits of
    another precision (a control); each precision also with the int8 KV
    cache and with a prefill in two chunks, under the same limits and
    controls (the greedy token there within the logits' limit of the
    CPU's). The model axis on one card (``model_axis_check``): the cut
    judge with ``mesh=create_mesh((1, 1))`` gives ``mesh=None``'s greedy
    tokens, and ``tp=2`` raises its ``ValueError`` (four cards:
    ``tools/multichip_smoke.py --phases e``). The
    int4 judge's generator options on the same request: the int8 KV cache
    and ``prefill_chunk=512`` (4 chunks), prefill and decode times beside
    the plain run's; a sampled generation (temperature 0.7, top_p 0.9, a
    fixed seed, 16 tokens) twice: every token inside its step's filtered
    support, the same tokens for the same seed. Then step4
    (``run_vlm_audit_pipeline``) on the cohort's CV experiment with the
    int4 judge: 4 cases, 64 new tokens, both artifacts, every case through
    K7 and K8. Then serving: the 12 audit requests of the cohort's CV folds
    (new-token budgets 16 to 64, two sampled) on the int4 and the bf16
    judge, one at a time (``generate``), in static batches of 8
    (``generate_batch``) and through continuous batching at 4 and 8 slots
    (``generate_stream``): host wall, cases/s and tokens/s of each, every
    run's K7 / K8 launches equal to its replayed and prefilled forwards, and
    the host ms of its graph captures; each greedy request's batched stream
    equal to the one at a time, or its first difference a near-tie (the
    B = 1 top-two logit gap within 0.75 in int4, 0.2 in bf16; the B = 1
    logits rebuilt on the generator must choose the one-at-a-time token),
    and the static batch rebuilt there choosing the batch's token at each
    first difference, its distance from the B = 1 logits printed; the
    8-slot wave served again on the kept slot state and graphs, every
    stream equal to the first wave's and its first replayed chunk step bit
    for bit equal to the eager step; on the int4 judge a wave on a fresh
    state with every draw, one per slot a step and one per insert, inside
    its filtered support (counted on the card, in the graph); step4
    with ``vlm_batch_size=4`` and with ``serving="continuous"`` (artifacts'
    rows, launches); the JSONL serve CLI on a file with a bad line and a
    missing image. Then speculative decoding and AWQ (``spec_awq_phase``),
    with the int8 judge released: an int4_awq judge built from the bf16
    weights on the card (calibration on 4 x 256 ids of the judge's prompts,
    the search, the fold, K7's quantization, timed; every site's AWQ error
    at most its RTN error, a consistency check of the search; the judge
    request's last-position prefill logits' cosine to bf16 for int4 and
    int4_awq, plain and with JAX's outlier-embedding fixture applied,
    printed; the gate against RTN on that fixture at 4 layers, where
    int4_awq's mean logits cosine must beat int4's by 0.005; step4 on 4
    cases with it, every case through K7 and K8); speculative decoding at
    B = 1 on the int4 judge, k = 4, with the self-draft and with a seeded
    4-layer draft at the 8B's widths (built through ``QwenVLBackend(
    draft_config=..., draft_params=...)``): each greedy stream against the
    plain generator's (equal, or a near-tie within 0.75 at the first
    difference), the kept cycle graph's first replayed cycle against the
    eager cycle bit for bit, K7 and K8 launches against both models'
    forwards, acceptance, tokens a cycle, the cycle's ms and ms per token
    beside plain graph decode's; a sampled speculative generation twice
    (the same tokens, every emitted token inside the target's filtered
    support, counted in the graph); speculative continuous serving of the
    12 fold requests at 8 slots with the self-draft (greedy streams against
    one at a time, rates beside plain continuous 8's, K7 at T = 40) and
    step4 through the speculative backend. The reduced-depth check also
    runs int4_awq (int4's limits and control), whose AWQ computed on the
    card picks the CPU's alphas.
    Last, the CV runner's ``_run_vlm_review`` (the G2 review) on
    the cohort's CV folds with the int4 judge passed in through
    ``VLMReviewModule(backend=...)``: 2 reviews, new tokens capped at 32,
    every review's text generated, K7 on every decoder forward (a review's
    one montage is one frame, which the vision tower attends on its flat
    path, as JAX's does). A stub
    word-level tokenizer stands in for Qwen's.

    Then ``Qwen3VLEncoder`` on the bf16 judge's model (no second copy):
    the taps (blocks 24 to 26, mean-pooled, averaged) of two cohort slices
    and the masked mean of the cohort's 12 clinical texts, no kernel
    launched (one image a forward takes the flat vision attention; the
    bf16 decoder has no kernel); the same weights cut to 2 vision blocks
    and 2 text layers, card against CPU (cosine >= 0.9998); the CV runner
    on a combined npz with those Qwen text rows (``--text_encoder
    qwen3_vl_8b``), card and ``--device cpu`` folds equal; step2
    ``--encoder_type qwen3_vl_8b --model_path`` on a checkpoint directory
    written from the cut weights (``tools/qwen_checkpoint``: config.json and
    model.safetensors at the 8B's widths) for 2 patients.
12b. The encoder zoo, between the main path and the judge: step2's CLI
    with ``--encoder_type vit`` (timm ViT-B/16, random weights from seed 0)
    plain f32, ``--fast`` (K1 + K3 on every block of every device batch)
    and ``--fast int8`` (K2 + K4); CLIP at
    openai/clip-vit-large-patch14-336's geometry (random weights, a stub
    character tokenizer) with ``fast="int8"`` (K2 with quick_gelu on every
    vision block, the vision attention's projections and every text
    projection on K5: the reference's rule refuses the fused attention at
    S = 577 even in int8) and ``fast=True`` (no fused kernel: the rule
    refuses both halves in bf16), 8 slices and 16 texts; CLIP ViT-B/16's
    12-block vision tower with ``fast=True`` (K1 with quick_gelu, K3) on
    32 slices; step2 ``--encoder_type dino`` (DINOv3 ViT-L/16)
    with ``--fast`` and ``--fast int8`` (every projection on K5) at batch
    16 (decoded on the pool, as JAX's: the pool's counter must show every
    device batch). Each run's launch counts, read just after it, equal its blocks'
    and 0 for every other kernel; its rows against the same weights' plain
    tower on the CPU (f32, or int8 for the int8 runs; cosine >= 0.999);
    each tower's slices/s at its batch.
12c. The paper's baselines, the trainer and the bring-up CLI. Inside the
    judge phase, before the judges are released: the VLM direct-judging
    baseline's CLI (``run_vlm_direct_judging.main``) on the int4 judge
    passed in (new tokens capped at 32 of its 2,048 by ``CappedBackend``,
    which caps ``generate``, ``generate_batch`` and ``generate_stream``):
    4 cohort patients at temperatures 0.0 and 0.7 sequentially, then with
    ``--serving continuous --n_slots 4`` (each greedy stream equal to the
    sequential one or first differing at a near-tie, B = 1 top-two gap
    within 0.75), then the fold protocol on the cohort's card CV
    experiment; every request generated text, both artifacts have JAX's
    keys, K8 = 27 x the vision forwards (at (4, 1024, 16, 72), also timed
    in phase 11), K7 = 7 x 36 x the decoder forwards, no other kernel;
    wall, cases/s and tokens/s. After the judge phase: the CNN baseline at
    full size (224², K = 4, batch 8, f32, TF32 off): a seeded
    torchvision-layout ResNet18 with random BN statistics converted, its
    eval backbone card against CPU (atol 2e-4, rtol 1e-3); one train step
    of each model card against CPU (loss, gradients, updated params,
    running statistics, each under its stated tolerance); the train step's
    ms (CUDA events, median of 10), images/s (``ThroughputMeter``), peak
    GiB and one ``trace_to`` capture naming its ``annotate`` stage; the
    CLI on the cohort (3 folds, 2 epochs, both models,
    ``--pretrained_path``) and ``compute_cnn_metrics`` on its results.json.
    The contrastive trainer at BioMedCLIP's width (ViT-B/16 and
    PubMedBERT-256 unfused in f32, batch 32): 3 steps on a fixed batch
    (finite, the third loss below the first, no port kernel launched), ``remat=True`` within
    1e-5 of plain, resume after save and restore equal to 4 straight steps
    (rtol 1e-5), card against CPU at 2 layers a tower (3 losses within
    rtol 1e-4), the refusal of a fused tower; step ms, peak GiB.
    ``bringup_qwen3_vl`` on the phase-12 checkpoint directory (the 8B's
    widths at depth 2, stub tokenizer) twice, its converted-params cache
    removed first: cold (the checkpoint read and converted once, the cache
    written) and cached (no read of the checkpoint); JAX's summary keys,
    finite embeddings, the same text generated by both, no kernel
    launched, both ``load_convert_s`` printed. ``StageTimer`` times
    the four stages and prints its summary.
13. Layer breakdown (``tools/layer_breakdown.main``, in-process, ViT-B/16
    block at B = 96): ``--what tune --merge_batch`` (K3m + K1), ``--what
    tune`` (K3 + K1), ``--what tune --act_bf16`` (K3 + K1's bf16 gelu) and
    ``--what int8block --act_bf16`` (K4 + K2's bf16 gelu); each run's launch
    counts equal its step calls (K3m only under ``--merge_batch``, K3 there
    0), and each prints its ms/iter.

Phase 3 also holds K1's and K2's bf16 gelu epilogues bit for bit against
``gelu_tanh_bf16`` on 400,000 values, their bf16 quick_gelu epilogues bit
for bit against the ``quick_gelu_bf16`` device function (which agrees with
the plain version within one bf16 ulp) and their f32 quick_gelu within
2^-20 (K2's f32 h1) and one bf16 ulp (K1's) of the plain version; and
times K1 with quick_gelu at CLIP ViT-B/16's (32, 200), K2 with quick_gelu
and K4 at CLIP ViT-L/14-336's width, (8, 584, 1,024), m = 4,096, 16 heads,
valid_len 577, against their plain versions. The main path starts from raw data: step1 builds the manifest from the
cohort's CSVs and folders (every patient matched, slices in natural order,
the hand-written manifest's patients), step2 and the later phases read it,
and step3 (``--test_size 0.3``) runs on the card and with ``--device cpu``,
whose ``retrieval_results.json`` must be equal.

Every kernel record carries its bound (the larger of its bytes over 3.35
TB/s and its operations over the card's peak for their type). The line
before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from emr2a_tpu_torch.ops import decode_attention
from emr2a_tpu_torch.tools.profile_judge import SERVING_BUDGETS
from emr2a_tpu_torch.tools.time_blocks import bound, close, nbytes
from emr2a_tpu_torch.tools.time_decode_attention import decode_records
from emr2a_tpu_torch.tools.time_linears import timing_text, timings

K6_N, K6_DIM, K6_K = 1_000_000, 512, 5


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


def core_occupancy(log: str) -> str:
    """The attention core's residency from ptxas's register count and its
    64 KB of shared memory a block (``csrc/attention_core.cuh``)."""
    m = re.search(r"Compiling entry function '\w*attention_core_kernel\w*'.*?Used (\d+) registers",
                  log, re.S)
    if not m:
        fail("no ptxas report of the attention core")
    regs = -(-int(m.group(1)) // 8) * 8
    threads, smem = 256, 64 * 1024
    blocks = min(65536 // (regs * threads), 233472 // (smem + 1024), 2048 // threads)
    return (f"attention core: {m.group(1)} registers a thread (ptxas), {smem} B of shared "
            f"memory and {threads // 32} warps a block: {blocks} blocks, {blocks * threads // 32} "
            f"warps an SM")


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
    """atol = rtol = 1e-2 and per-row cosine >= 0.9999
    (``time_blocks.close``); returns the max abs error."""
    try:
        err = close(got, want)
    except AssertionError as e:
        fail(f"{name} disagrees with its plain version: {e}")
    print(f"{name}: max_abs_err {err}", flush=True)
    return err


def linear_record(kernel: str, card: str, extra=()) -> dict:
    """K5 (``"k5"``) or K7 (``"k7"``) at ``tools/time_linears``'s shapes
    (and ``extra``): each bit for bit against its plain version, with its
    single and chained times, the plain version's and cuBLAS bf16's on the
    dequantized weight. The record's head is the T = 1, 4096->12288 decode
    shape for K7 and PubMedBERT's T = 8192, 768->3072 for K5."""
    from emr2a_tpu_torch.tools import time_linears
    shapes = []
    for shape in (*time_linears.shapes_of(kernel), *extra):
        try:
            shapes.append(time_linears.shape_record(kernel, *shape))
        except AssertionError as e:
            fail(str(e))
    name = {"k5": "linear_w8a8", "k7": "linear_w4a8"}[kernel]
    head = next(r for r in shapes if r["shape"] == (
        "T=8192, 768->3072" if kernel == "k5" else "T=1, 4096->12288"))
    print(f"{name}: bit-identical to its plain version at {len(shapes)} shapes ({card})",
          flush=True)
    return {"name": name, "route": "cuda",
            "source": f"emr2a_tpu_torch/csrc/{'linear_int8' if kernel == 'k5' else 'linear_int4'}.cu",
            "replaces": ("emr2a_tpu/ops/linear_int8.py:148" if kernel == "k5"
                         else "emr2a_tpu/ops/linear_int4.py:184"),
            **head, "max_abs_err": 0.0, "shapes": shapes}


def quantize_weight(w: torch.Tensor):
    """W8A8 codes and column scales, quantized on the card (the same bytes
    as the numpy recipe, checked in the judge kernel phase)."""
    from emr2a_tpu_torch.models.quantize import quantize_weight_int8_torch
    q, s = quantize_weight_int8_torch(w)
    return q, s.reshape(-1)


BLOCK_RECORDS = (
    # (time_blocks kernel, record name, source, the TPU kernel it replaces)
    ("k1", "fused_ln_mlp", "mlp.cu", "emr2a_tpu/ops/mlp.py:75"),
    ("k3", "fused_ln_attention", "attention_block.cu", "emr2a_tpu/ops/attention_block.py:270"),
    ("k3m", "fused_ln_attention_merged", "attention_block.cu",
     "emr2a_tpu/ops/attention_block.py:179"),
    ("k4", "fused_ln_attention_int8", "attention_block_int8.cu",
     "emr2a_tpu/ops/attention_block.py:436"),
    ("k2", "fused_ln_mlp_int8", "mlp_int8.cu", "emr2a_tpu/ops/mlp.py:194"),
    ("k1_bf16_gelu", "fused_ln_mlp act_dtype=bf16", "mlp.cu", "emr2a_tpu/ops/mlp.py:75"),
    ("k2_bf16_gelu", "fused_ln_mlp_int8 act_dtype=bf16", "mlp_int8.cu",
     "emr2a_tpu/ops/mlp.py:194"),
    ("k1_quick_gelu", "fused_ln_mlp activation=quick_gelu", "mlp.cu", "emr2a_tpu/ops/mlp.py:75"),
    ("k2_quick_gelu", "fused_ln_mlp_int8 activation=quick_gelu", "mlp_int8.cu",
     "emr2a_tpu/ops/mlp.py:194"),
    ("k4_clip_l", "fused_ln_attention_int8 ViT-L/14-336", "attention_block_int8.cu",
     "emr2a_tpu/ops/attention_block.py:436"),
)
LONG_SEQ = (2, 577, 768, 12, 570)   # ViT-B width at S = 577, which the routing rule admits


def block_phase(card: str) -> list:
    """K1 and K2 (each also with its bf16 gelu), K3, K3m and K4 through
    ``tools/time_blocks``: each against its plain version at the main
    path's shapes (K3m bit for bit against K3), single, chained and
    CUDA-graph times beside the yardstick (plain bf16 PyTorch, or for K2 and
    K4 the plain version on ``torch._int_mm``), the bound and the device
    time by launch; the record's head is its first shape."""
    from emr2a_tpu_torch.tools import time_blocks

    try:
        blocks = time_blocks.block_records(tuple(k for k, *_ in BLOCK_RECORDS))
    except AssertionError as e:
        fail(f"block kernels: {e}")
    records = []
    for kernel, name, source, replaces in BLOCK_RECORDS:
        shapes = blocks[kernel]
        records.append({"name": name, "route": "cuda", "source": f"emr2a_tpu_torch/csrc/{source}",
                        "replaces": replaces, **shapes[0],
                        "max_abs_err": max(r["max_abs_err"] for r in shapes), "shapes": shapes})
        print(f"{name}: {len(shapes)} shapes against the plain version"
              + (", bit-identical to K3" if kernel == "k3m" else "") + f" ({card})", flush=True)
    for rec in records:
        if rec["name"].endswith("act_dtype=bf16"):
            rec["gelu_epilogue_bit_identical_values"] = GELU_VALUES
    for k3m, k3 in zip(blocks["k3m"], blocks["k3"]):
        print(f"K3m {k3m['shape']}: group {k3m['group']} x {k3m['groups']} on "
              f"{k3m['streams']} stream(s), {k3m['device_launches_per_call']} device launches "
              f"a call; single / chained / graph {k3m['ms']:.4f} / {k3m['chained_ms']:.4f} / "
              f"{k3m['graph_ms']:.4f} ms beside K3's {k3['ms']:.4f} / {k3['chained_ms']:.4f} / "
              f"{k3['graph_ms']:.4f} (graph {k3m['graph_ms'] / k3['graph_ms']:.3f} x K3); "
              f"bit-identical to K3 ({card})", flush=True)
    return records


def long_sequence_check() -> None:
    """K3 and K4 at LONG_SEQ (K/V streamed through the attention core's
    slots) against their plain versions; K3m bit for bit against K3 there,
    at a B that is no multiple of its group and at B < block_b."""
    from emr2a_tpu_torch.ops import attention_block

    B, S, d, H, valid_len = LONG_SEQ
    g = torch.Generator(device="cuda").manual_seed(577)
    rn = lambda *shape, std=1.0: (torch.randn(*shape, generator=g, device="cuda")
                                  * std).to(torch.bfloat16)
    x = rn(B, S, d)
    ln = ((1.0 + rn(d, std=0.1).float()).to(torch.bfloat16), rn(d, std=0.1))
    w = [rn(d, d, std=0.02) if i % 2 == 0 else rn(d, std=0.02) for i in range(8)]
    wq = []
    for i in (0, 2, 4, 6):
        wq += [*quantize_weight(w[i]), w[i + 1]]
    tag = f"({B}, {S}, {d}), valid_len {valid_len}"
    k3 = attention_block.fused_ln_attention(x, *ln, *w, num_heads=H, valid_len=valid_len)
    k3m = attention_block.fused_ln_attention(x, *ln, *w, num_heads=H, valid_len=valid_len,
                                             block_b=1, merge_batch=True)
    k4 = attention_block.fused_ln_attention_int8(x, *ln, *wq, num_heads=H, valid_len=valid_len)
    torch.cuda.synchronize()
    compare(f"fused_ln_attention {tag}", k3[:, :valid_len],
            attention_block.fused_ln_attention_reference(
                x, *ln, *w, num_heads=H, valid_len=valid_len)[:, :valid_len])
    compare(f"fused_ln_attention_int8 {tag}", k4[:, :valid_len],
            attention_block.fused_ln_attention_int8_reference(
                x, *ln, *wq, num_heads=H, valid_len=valid_len)[:, :valid_len])
    if not torch.equal(k3m, k3):
        fail(f"fused_ln_attention merge_batch {tag}: not bit-identical to K3")
    print(f"fused_ln_attention merge_batch {tag}: bit-identical to K3", flush=True)
    # K3m where B is no multiple of its group (24 + 13) and where B < block_b
    for B in (37, 3):
        x = rn(B, 200, d)
        k3 = attention_block.fused_ln_attention(x, *ln, *w, num_heads=H, valid_len=197)
        k3m = attention_block.fused_ln_attention(x, *ln, *w, num_heads=H, valid_len=197,
                                                 block_b=4, merge_batch=True)
        torch.cuda.synchronize()
        G = attention_block.merged_group(B, 200, d, 4, *attention_block.device_caps(
            torch.cuda.current_device()))
        if not torch.equal(k3m, k3):
            fail(f"fused_ln_attention merge_batch ({B}, 200, {d}): not bit-identical to K3")
        print(f"fused_ln_attention merge_batch ({B}, 200, {d}), block_b 4: group {G}, "
              f"bit-identical to K3", flush=True)


def kernel_phase(card: str) -> list:
    from emr2a_tpu_torch.ops import quant

    records = block_phase(card)
    long_sequence_check()
    gelu_epilogue_check()
    quick = quick_gelu_epilogue_check()
    for rec in records:
        if rec["name"].endswith("quick_gelu"):
            rec["quick_gelu_epilogue_check"] = {"values": GELU_VALUES, **quick}

    g = torch.Generator(device="cuda").manual_seed(0)
    T, d, m = 32 * 200, 768, 3072
    x2 = (torch.randn(T, d, generator=g, device="cuda")).to(torch.bfloat16)

    # K5 at every shape the int8 judge gives it (the decoder's q/o, k/v,
    # gate/up and down projections at its prefill, T = 2048, and its decode,
    # T = 1), at the PubMedBERT shapes (T = 32 texts x 256 tokens) and at
    # T = 32: bit for bit, single and chained times beside cuBLAS bf16 on the
    # dequantized weight (tools/time_linears.py); also at the encoder zoo's
    # shapes: DINOv3 ViT-L int8 at T = 16 x 201 (1024->1024/4096,
    # 4096->1024), CLIP ViT-L/14-336 int8's vision attention at T = 8 x 584
    # and its text tower at T = 8 x 77 (768->768/3072, 3072->768)
    records.append(linear_record("k5", card, extra=(
        (32, 768, 3072), (3216, 1024, 1024), (3216, 1024, 4096), (3216, 4096, 1024),
        (4672, 1024, 1024), (616, 768, 768), (616, 768, 3072), (616, 3072, 768))))

    # the shared row quantize: codes and scales equal the plain version's
    for xq in (x2, torch.randn(T, m, generator=g, device="cuda")):
        q, s = quant.quantize_rows_s8(xq)
        want_q, want_s = quant.quantize_rows_s8_reference(xq)
        if not (torch.equal(q, want_q) and torch.equal(s, want_s)):
            fail(f"quantize_rows_s8 ({xq.dtype}): codes differ from the plain version")
    print("quantize_rows_s8: codes and scales bit-identical to the plain "
          "version (bf16 and f32 rows)", flush=True)
    return records


GELU_VALUES = 400_000      # a multiple of the GEMMs' 128-column tile


def gelu_epilogue_check() -> None:
    """K1's and K2's gelu epilogues against ``gelu_tanh_bf16`` bit for bit,
    on the 400,000 values ``tests/test_torch_act_dtype.py`` holds to XLA.
    Each kernel entry is called with its fc1 weights zero and b1 = those
    values, so that its fc1 output is b1 exactly and its h1 scratch (read
    back here) is the epilogue's gelu of them: K1's in bf16, K2's in f32.
    With act_bf16 off the same scratch must differ (the f32 gelu), so the
    flag reaches the epilogue. These calls bypass the wrappers and their
    launch counts."""
    import ctypes
    from emr2a_tpu_torch.ops import _build, mlp

    v = torch.from_numpy((np.random.RandomState(3).randn(GELU_VALUES) * 3)
                         .astype(np.float32)).to(torch.bfloat16)
    want = mlp.gelu_tanh_bf16(v.float())            # plain, on the CPU
    T, d, m = 8, 128, GELU_VALUES
    dev, bf = torch.device("cuda"), torch.bfloat16
    x = torch.randn(T, d, device=dev).to(bf)
    ln_s, ln_b = torch.ones(d, device=dev, dtype=bf), torch.zeros(d, device=dev, dtype=bf)
    b1, b2 = v.to(dev), torch.zeros(d, device=dev, dtype=bf)
    stream = torch.cuda.current_stream().cuda_stream
    p, i = ctypes.c_void_p, ctypes.c_int
    ptrs = lambda *ts: [t.data_ptr() for t in ts]

    k1 = _build.kernel_function("emr2a_fused_ln_mlp", mlp._argtypes())
    w1, w2 = torch.zeros(d, m, device=dev, dtype=bf), torch.zeros(m, d, device=dev, dtype=bf)
    k2 = _build.kernel_function("emr2a_fused_ln_mlp_int8",
                                [p] * 15 + [i, i, i, i, ctypes.c_float, p])
    w1q, w2q = (torch.zeros(d, m, device=dev, dtype=torch.int8),
                torch.zeros(m, d, device=dev, dtype=torch.int8))
    w1s, w2s = torch.ones(m, device=dev), torch.ones(d, device=dev)
    h1s = {}
    for act_bf16 in (1, 0):
        h1 = torch.empty(T, m, device=dev, dtype=bf)
        _build.check(k1(*ptrs(x, ln_s, ln_b, w1, b1, w2, b2, h1, torch.empty_like(x)),
                        T, d, m, act_bf16, 1e-6, stream), "fused_ln_mlp")
        h1_8 = torch.empty(T, m, device=dev)
        scratch = (torch.empty(T, d, device=dev, dtype=torch.int8), torch.empty(T, device=dev),
                   h1_8, torch.empty(T, m, device=dev, dtype=torch.int8),
                   torch.empty(T, device=dev), torch.empty_like(x))
        _build.check(k2(*ptrs(x, ln_s, ln_b, w1q, w1s, b1, w2q, w2s, b2, *scratch),
                        T, d, m, act_bf16, 1e-6, stream), "fused_ln_mlp_int8")
        torch.cuda.synchronize()
        h1s[act_bf16] = (h1.cpu(), h1_8.cpu())
    for name, got, exact, f32 in (
            ("fused_ln_mlp", h1s[1][0], want.to(bf), h1s[0][0]),
            ("fused_ln_mlp_int8", h1s[1][1], want, h1s[0][1])):
        bad = (got != exact.expand_as(got)).sum().item()
        if bad:
            fail(f"{name} act_dtype=bf16: the gelu epilogue differs from "
                 f"gelu_tanh_bf16 at {bad} of {got.numel()} values")
        if torch.equal(got, f32):
            fail(f"{name}: act_bf16 does not change the gelu epilogue")
        print(f"{name} act_dtype=bf16: gelu epilogue bit-identical to gelu_tanh_bf16 "
              f"on {GELU_VALUES} values x {T} rows; the f32 epilogue differs at "
              f"{(got != f32).sum().item()} of them", flush=True)


def reset_counts() -> None:
    from emr2a_tpu_torch.ops import (attention, attention_block, linear_int4,
                                     linear_int8, mlp, quant, topk, vision_flash)
    decode_attention.LAUNCHES = 0
    mlp.LAUNCHES = mlp.INT8_LAUNCHES = 0
    attention_block.LAUNCHES = attention_block.INT8_LAUNCHES = 0
    attention_block.MERGED_LAUNCHES = 0
    linear_int8.LAUNCHES = quant.LAUNCHES = 0
    topk.LAUNCHES = topk.INT8_LAUNCHES = topk.TILE_LAUNCHES = 0
    linear_int4.LAUNCHES = vision_flash.LAUNCHES = attention.LAUNCHES = 0


def read_counts() -> dict:
    from emr2a_tpu_torch.ops import (attention, attention_block, linear_int4,
                                     linear_int8, mlp, topk, vision_flash)
    return {"fused_ln_mlp": mlp.LAUNCHES,
            "fused_ln_attention": attention_block.LAUNCHES,
            "fused_ln_attention_merged": attention_block.MERGED_LAUNCHES,
            "fused_ln_mlp_int8": mlp.INT8_LAUNCHES,
            "fused_ln_attention_int8": attention_block.INT8_LAUNCHES,
            "linear_w8a8": linear_int8.LAUNCHES,
            "cosine_topk_fused": topk.LAUNCHES,
            "cosine_topk_fused_int8": topk.INT8_LAUNCHES,
            "cosine_topk tile scan": topk.TILE_LAUNCHES,
            "linear_w4a8": linear_int4.LAUNCHES,
            "frame_flash_attention": vision_flash.LAUNCHES,
            "fused_attention": attention.LAUNCHES,
            "decode_attention": decode_attention.LAUNCHES}


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


POOL_JPEGS = (("baseline 4:2:0", "RGB", dict(quality=90, subsampling=2)),
              ("baseline 4:4:4", "RGB", dict(quality=90, subsampling=0)),
              ("progressive", "RGB", dict(quality=90, progressive=True)),
              ("grey", "L", dict(quality=90)))
POOL_RGB_PATIENTS = 2         # of the rgb=True cohort (40 slices each)
POOL_HOST_SLICES = 96         # slices timed on the per-image host path
POOL_PIL_SLICES = 192         # slices timed on PIL's thread pool
E2E_BATCH = 96                # scripts/exp_step2_e2e.py's batch_size = max_batch
E2E_PATIENT_SLICES = 192      # its slices a patient (tools/step2_e2e's default too)
# (run, pool, step2 batch_size); max_batch is E2E_BATCH in every run. The JAX
# script's setting puts one pool chunk in each step2 call; the last run puts
# two, so the second is decoded while the first is on the card.
E2E_RUNS = (("pool", True, E2E_BATCH), ("no_pool", False, E2E_BATCH),
            ("pool double-buffered", True, 2 * E2E_BATCH))


def slice_paths(manifest_path: Path) -> list:
    return [p for line in manifest_path.read_text(encoding="utf-8").splitlines()
            for p in json.loads(line)["slices"]]


def pool_phase(work: Path, manifest_path: Path, card: str) -> dict:
    """The C++ decode pool (``data/native_loader.py``): built from the repo's
    sources; every slice of the grey cohort, of an rgb=True cohort and a few
    JPEGs of its slices (baseline 4:2:0 and 4:4:4, progressive, grey) byte
    for byte against PIL's decode passed through ``resize_rgb_reference``,
    at the slices' own 512 x 512 and at 224 x 224; then slices/s at 224 on
    1 thread and on every core, beside the per-image host path
    (``load_image_rgb`` + ``resize_to``), PIL's decode on a thread pool of
    every core (alone, and with ``resize_rgb_reference`` after it) and the
    host's core count."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    from emr2a_tpu_torch.data import native_loader
    from emr2a_tpu_torch.data.images import load_image_rgb, resize_to
    from emr2a_tpu_torch.tools.cohort import write_cohort

    t0 = time.time()
    lib = native_loader.build()
    if not native_loader.native_available():
        fail("decode pool: native_available() is False after the build")
    sources = sorted(p.name for p in native_loader.SOURCE_DIR.iterdir())
    print(f"decode pool built from emr2a_tpu_torch/native ({', '.join(sources)}) with "
          f"{native_loader.compiler()} {' '.join(native_loader.CXX_FLAGS)} in "
          f"{time.time() - t0:.1f} s: {lib.name}", flush=True)

    grey = slice_paths(manifest_path)
    t0 = time.time()
    rgb = slice_paths(write_cohort(work / "cohort_rgb", n_patients=POOL_RGB_PATIENTS,
                                   rgb=True))
    jpegs = []
    (work / "jpegs").mkdir()
    for i, (tag, mode, kw) in enumerate(POOL_JPEGS):
        path = work / "jpegs" / f"{tag.replace(' ', '_').replace(':', '')}.jpg"
        with Image.open(grey[i * 41]) as im:
            im.convert(mode).save(path, **kw)
        jpegs.append(path)
    print(f"decode pool inputs: {len(grey)} grey PNGs, {len(rgb)} RGB PNGs (written in "
          f"{time.time() - t0:.1f} s), {len(jpegs)} JPEGs "
          f"({', '.join(t for t, _, _ in POOL_JPEGS)})", flush=True)

    t0 = time.time()
    held = 0
    for tag, paths in (("grey cohort", grey), ("rgb cohort", rgb), ("jpeg", jpegs)):
        for start in range(0, len(paths), 96):
            chunk = paths[start:start + 96]
            rows = {size: native_loader.decode_batch(chunk, size, size) for size in (512, 224)}
            for size, (_, ok) in rows.items():
                if not ok.all():
                    fail(f"decode pool {tag}: {int((~ok).sum())} of {len(chunk)} failed at "
                         f"{size}")
            for j, path in enumerate(chunk):
                with Image.open(path) as im:
                    pil = np.asarray(im.convert("RGB"))
                for size, (batch, _) in rows.items():
                    want = native_loader.resize_rgb_reference(pil, size, size)
                    if not np.array_equal(batch[j], want):
                        fail(f"decode pool {tag}: {path} differs from PIL + "
                             f"resize_rgb_reference at {size} ({int((batch[j] != want).sum())} "
                             f"bytes)")
                held += 1
    print(f"decode pool: {held} images ({len(grey)} grey PNG, {len(rgb)} RGB PNG, "
          f"{len(jpegs)} JPEG) byte-identical to PIL's decode + resize_rgb_reference at "
          f"512x512 and 224x224 ({time.time() - t0:.1f} s)", flush=True)

    def rate(fn, n, repeats=3) -> float:
        best = float("inf")
        for _ in range(repeats):
            t = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t)
        return n / best

    cores, usable = os.cpu_count(), len(os.sched_getaffinity(0))
    one = rate(lambda: native_loader.decode_batch(grey, 224, 224, n_threads=1), len(grey))
    every = rate(lambda: native_loader.decode_batch(grey, 224, 224, n_threads=0), len(grey))
    host_paths = grey[:POOL_HOST_SLICES]
    host = rate(lambda: [resize_to(load_image_rgb(p), 224, shortest_edge=False)
                         for p in host_paths], len(host_paths))

    def pil_decode(path):
        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"))

    pil_paths = grey[:POOL_PIL_SLICES]
    with ThreadPoolExecutor(max_workers=usable) as ex:
        pil = rate(lambda: list(ex.map(pil_decode, pil_paths)), len(pil_paths))
        pil_resized = rate(lambda: list(ex.map(
            lambda p: native_loader.resize_rgb_reference(pil_decode(p), 224, 224),
            pil_paths)), len(pil_paths))
    print(f"decode pool throughput, 512x512 grey PNG -> 224x224 RGB, best of 3: "
          f"{one:.1f} slices/s on 1 thread, {every:.1f} slices/s on all cores "
          f"(os.cpu_count() {cores}, sched_getaffinity {usable}); per-image host path "
          f"(load_image_rgb + resize_to, cv2) {host:.1f} slices/s; PIL on a pool of "
          f"{usable} threads: decode alone {pil:.1f} slices/s, decode + resize_rgb_reference "
          f"{pil_resized:.1f} slices/s ({card})", flush=True)
    return {"pool_1_thread": one, "pool_all_cores": every, "host_per_image": host,
            "pil_threads_decode": pil, "pil_threads_resized": pil_resized,
            "cpu_count": cores, "affinity": usable}


def e2e_patients(image_paths: dict) -> dict:
    """The cohort's slices regrouped into patients of E2E_PATIENT_SLICES
    (192, 192 and 96 of the 480), the JAX script's patient size."""
    flat = [p for paths in image_paths.values() for p in paths]
    n = E2E_PATIENT_SLICES
    return {f"e2e{i // n:02d}": flat[i:i + n] for i in range(0, len(flat), n)}


def e2e_phase(work: Path, image_paths: dict, encoders: dict, plain_cpu, int8_cpu,
              card: str) -> dict:
    """``tools/step2_e2e``'s measurement with the main path's BioMedCLIP
    encoders at max_batch E2E_BATCH, for each of E2E_RUNS: step2 on the
    decode pool (``assume_square_sources``) at the JAX script's batch_size,
    on the per-image host decode (cv2) at the same setting, and on the pool
    with two chunks a call. Each run's counts, reset just before and read
    just after, must show every block of every device batch (warm-up
    included) on the precision's two kernels, and the pool counter its
    chunks. The pool run's first chunk is held against the plain towers on
    the CPU fed the same pool-decoded bytes: bf16 against the f32 tower,
    int8 against the int8 tower's plain version (both printed for int8);
    the double-buffered run's rows against the pool run's; the host-decode
    run's rows against the pool run's only as a check of the decoder."""
    from emr2a_tpu_torch.data import native_loader
    from emr2a_tpu_torch.tools import step2_e2e

    kernels = {"bf16": ("fused_ln_mlp", "fused_ln_attention"),
               "int8": ("fused_ln_mlp_int8", "fused_ln_attention_int8")}
    patients = e2e_patients(image_paths)
    first = next(iter(patients.values()))
    size = plain_cpu.preprocess.resize_size
    chunk, ok = native_loader.decode_batch(first[:E2E_BATCH], size, size)
    if not ok.all():
        fail(f"step2 e2e: {int((~ok).sum())} slices of the first chunk failed to decode")
    t0 = time.time()
    want = {"f32": plain_cpu._image_forward(chunk), "int8": int8_cpu._image_forward(chunk)}
    print(f"step2 e2e: plain f32 and int8 towers on the CPU over the first pool chunk "
          f"({E2E_BATCH} slices) in {time.time() - t0:.1f} s", flush=True)
    out = {"rates": {}, "launches": {}}
    for prec, enc in encoders.items():
        old = enc.max_batch
        enc.max_batch = E2E_BATCH
        try:
            embs = {}
            for run, pool, batch in E2E_RUNS:
                tag = f"{prec} {run}"
                calls = [len(p[s:s + batch]) for p in patients.values()
                         for s in range(0, len(p), batch)]
                pool_batches = sum(-(-n // E2E_BATCH) for n in calls) if pool else 0
                device_batches = sum(-(-n // E2E_BATCH)
                                     for n in calls + [min(batch, len(first))])
                run_dir = work / "e2e" / tag.replace(" ", "_")
                torch.cuda.synchronize()
                reset_counts()
                res = step2_e2e.measure(enc, patients, run_dir, batch, pool=pool)
                torch.cuda.synchronize()
                launches = read_counts()
                check_launches(f"step2 e2e {tag}", launches,
                               {k: 12 * device_batches for k in kernels[prec]})
                if res["pool_batches"] != pool_batches:
                    fail(f"step2 e2e {tag}: {res['pool_batches']} pool batches, expected "
                         f"{pool_batches}")
                if res["encoded"] != res["slices"]:
                    fail(f"step2 e2e {tag}: encoded {res['encoded']} of {res['slices']}")
                npz = np.load(run_dir / "embeddings.npz")
                embs[run] = np.concatenate([npz[k] for k in patients])
                out["rates"][tag] = res
                if pool:
                    out["launches"][f"step2 e2e {tag}"] = launches
                print(f"step2 e2e {tag}: {res['encoded']} slices in {len(patients)} patients "
                      f"of up to {E2E_PATIENT_SLICES}, batch_size {batch}, max_batch "
                      f"{E2E_BATCH}, {res['pool_batches']} pool batches, end to end "
                      f"{res['end_to_end_slices_per_s']:.1f} slices/s, embed "
                      f"{res['embed_slices_per_s']:.1f} slices/s (embed {res['embed_s']:.3f} s, "
                      f"save {res['save_s']:.3f} s); launches {nonzero(launches)} ({card})",
                      flush=True)
        finally:
            enc.max_batch = old
        got = embs["pool"][:E2E_BATCH]
        cos = {ref: cosines(got, w) for ref, w in want.items()}
        print(f"step2 e2e {prec} pool, first chunk ({E2E_BATCH} slices at T = {E2E_BATCH} x "
              f"197) vs the plain towers on the CPU on the pool's bytes: min cosine "
              + ", ".join(f"{c.min():.6f} vs {ref}" for ref, c in cos.items()), flush=True)
        ref = "f32" if prec == "bf16" else "int8"
        if cos[ref].min() < 0.999:
            fail(f"step2 e2e {prec}: the kernels disagree with the {ref} plain tower on the "
                 f"pool's first chunk: cosine {cos[ref]}")
        dbl = cosines(embs["pool double-buffered"], embs["pool"])
        diff = np.abs(embs["pool double-buffered"] - embs["pool"]).max()
        print(f"step2 e2e {prec}: double-buffered vs one chunk a call, {len(dbl)} rows: min "
              f"cosine {dbl.min():.8f}, max |diff| {diff:.3g}", flush=True)
        if dbl.min() < 0.99999:
            fail(f"step2 e2e {prec}: the double-buffered run's rows differ from the pool run's")
        host = cosines(embs["pool"], embs["no_pool"])
        print(f"step2 e2e {prec}: pool vs per-image host decode (INTER_AREA vs the pool's box "
              f"filter), min row cosine {host.min():.6f}", flush=True)
        if host.min() < 0.99:
            fail(f"step2 e2e {prec}: the pool's and the host decode's embeddings disagree")
    return out


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


K6_QS = (1, 4, 8, 16, 32, 64)
K6_CODE = {"f32": 0, "bf16": 1, "int8": 2}


def k6_inputs(seed: int = 6):
    """Seeded unit rows at 1M x 512 in each storage type (the int8 DB's
    recipe for the codes) and 64 unit queries."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    unit = lambda *shape: torch.nn.functional.normalize(
        torch.randn(*shape, generator=g, device="cuda"), dim=-1)
    db32 = unit(K6_N, K6_DIM)
    queries64 = unit(64, K6_DIM)
    amax = db32.abs().amax(dim=1)
    scales = amax / torch.full_like(amax, 127.0)
    scales = torch.where(scales == 0, torch.ones_like(scales), scales)
    codes = torch.clamp(torch.round(db32 / scales[:, None]), -127, 127).to(torch.int8)
    return {"f32": db32, "bf16": db32.to(torch.bfloat16), "int8": (codes, scales)}, queries64


def k6_check(tag: str, dtype: str, got, want, queries, store) -> float:
    """int8 bit for bit; f32/bf16 values within 1e-5 and indices equal up
    to near-ties. Returns the max abs error."""
    if dtype == "int8":
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            fail(f"{tag}: not bit-identical to its plain version")
        print(f"{tag}: bit-identical to its plain version", flush=True)
        return 0.0
    scores = queries.to(store.dtype).float() @ store.float().T
    err = topk_agrees(tag, got, want, scores)
    del scores
    return err


def topk_kernel_phase(card: str) -> list:
    """K6 at 1M x 512, k = 5, q in K6_QS, each storage type: both scans
    (the streaming scan and the tile scan, forced through TILE_MIN_Q)
    against the plain version, timed beside the library yardstick; the
    crossover; k = 100 at q = 64 against the plain version."""
    from emr2a_tpu_torch.ops import topk

    stores, queries64 = k6_inputs()
    shapes = {"cosine_topk_fused": [], "cosine_topk_fused_int8": []}
    default_min_q = dict(topk.TILE_MIN_Q)
    crossover = {}
    try:
        for dtype in ("f32", "bf16", "int8"):
            code = K6_CODE[dtype]
            faster = {}
            for qn, k in [(q, K6_K) for q in K6_QS] + [(64, 100)]:
                queries = queries64[:qn].contiguous()
                ops = 2 * qn * K6_N * K6_DIM
                out_bytes = qn * k * 8
                if dtype == "int8":
                    codes, scales = stores["int8"]
                    fn = lambda: topk.cosine_topk_fused_int8(queries, codes, scales, k)
                    ref = lambda: topk.cosine_topk_fused_int8_reference(queries, codes, scales, k)

                    def lib():
                        qc, qs = topk.quantize_queries_int8(queries)
                        s32 = torch._int_mm(qc, codes.t())
                        return torch.topk(s32.float() * qs[:, None] * scales[None, :], k)
                    library = lib if qn > 16 else None   # _int_mm needs m > 16
                    bnd = bound(nbytes(codes, scales, queries) + out_bytes, [("int8", ops)])
                    store = None
                else:
                    store = stores[dtype]
                    qs_ = queries.to(store.dtype)
                    fn = lambda: topk.cosine_topk_fused(queries, store, k)
                    ref = lambda: topk.cosine_topk_fused_reference(queries, store, k)
                    library = lambda: torch.topk(qs_ @ store.T, k)
                    bnd = bound(nbytes(store, qs_) + out_bytes, [(dtype, ops)])
                name = f"cosine_topk_fused{'_int8' if dtype == 'int8' else ''}"
                want = ref()
                rec = {"shape": f"{dtype}, q={qn}, n={K6_N}, dim={K6_DIM}, k={k}"}
                paths = ("tile",) if k > topk.SCAN_K_MAX else ("stream", "tile")
                for path in paths:
                    topk.TILE_MIN_Q[code] = 1 if path == "tile" else 10 ** 9
                    before = topk.TILE_LAUNCHES
                    got = fn()
                    torch.cuda.synchronize()
                    if (topk.TILE_LAUNCHES - before == 1) != (path == "tile"):
                        fail(f"{name} {dtype} q={qn}: the {path} scan was not taken")
                    tag = f"{name} {dtype} q={qn} k={k} {path} scan"
                    err = k6_check(tag, dtype, got, want,
                                   queries if dtype != "int8" else None, store)
                    rec[f"{path}_max_abs_err"] = err
                    rec[path] = timings(fn)
                topk.TILE_MIN_Q[code] = default_min_q[code]
                chosen = "tile" if qn >= default_min_q[code] or k > topk.SCAN_K_MAX else "stream"
                rec.update({"path": chosen, "max_abs_err": rec[f"{chosen}_max_abs_err"],
                            **rec[chosen],
                            "plain_ms": median_ms(ref) if qn in (1, 64) and k == K6_K else None,
                            **bnd, "library_ms": median_ms(library) if library else None})
                if len(paths) == 2:
                    faster[qn] = rec["tile"]["chained_ms"] < rec["stream"]["chained_ms"]
                print(f"{name} {dtype} q={qn} k={k}: "
                      + "; ".join(f"{p_} scan {timing_text(rec[p_])}" for p_ in paths)
                      + f"; wrapper takes the {chosen} scan; plain version "
                      + (f"{rec['plain_ms']:.4f} ms" if rec["plain_ms"] else "not timed")
                      + ", library "
                      + (f"{rec['library_ms']:.4f} ms" if library else "none")
                      + f", bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}) ({card})",
                      flush=True)
                shapes[name].append(rec)
                torch.cuda.empty_cache()
            # the least q from which the tile scan is faster (chained) at every larger q
            crossover[dtype] = next((q for q in K6_QS if all(faster[x] for x in K6_QS if x >= q)),
                                    None)
            print(f"K6 crossover {dtype}: the tile scan is faster (chained) from q = "
                  f"{crossover[dtype]} on (the wrapper takes it from q = "
                  f"{default_min_q[code]}); {card}", flush=True)
    finally:
        topk.TILE_MIN_Q.update(default_min_q)
    records = []
    for name, recs in shapes.items():
        first = {k_: v for k_, v in recs[0].items() if k_ not in ("stream", "tile")}
        records.append({"name": name, "route": "cuda",
                        "source": "emr2a_tpu_torch/csrc/topk.cu",
                        "replaces": "emr2a_tpu/ops/topk.py:155", **first,
                        "max_abs_err": max(r["max_abs_err"] for r in recs),
                        "crossover_q": {d: crossover[d] for d in crossover
                                        if (d == "int8") == name.endswith("int8")},
                        "shapes": recs})
    del stores
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
    from emr2a_tpu_torch.ops import topk
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
                                      capacity=len(ids) + 4, device="cuda:0")
        got = db.topk(mat, 5)
        db.use_pallas = False
        want = db.topk(mat, 5)
        scores = db._queries(mat, True).float() @ db.shards[0][:db.n].float().T
        topk_agrees(f"database use_pallas {dtype} (padded buffer)", got, want, scores)
    torch.cuda.synchronize()
    launches = read_counts()
    print(f"database: launches {launches}", flush=True)
    for dtype, tol in (("f32", 1e-5), ("bf16", 1e-5), ("int8", 1e-3)):
        hits_agree(f"database_cli {dtype}", hits[dtype, "cuda"], hits[dtype, "cpu"], tol)
    for row in hits["f32", "cuda"]:
        if row["hits"][0]["patient_id"] != row["query_id"]:
            fail(f"database: {row['query_id']} did not retrieve itself first")
    # the tile scan where the wrapper's crossover sends these query counts
    tile = sum(len(ids) >= topk.TILE_MIN_Q[c] for c in (0, 1, 2))
    check_launches("database", launches, {"cosine_topk_fused": 2, "cosine_topk_fused_int8": 1,
                                          "cosine_topk tile scan": tile})
    return launches


def p50_phase(card: str) -> dict:
    """Single-query p50 of topk_chained (256 scans, CUDA events) on a
    seeded 1M x 512 database, each dtype; f32/bf16 with use_pallas off and
    on. Then a batched topk of 64 queries at k = 5 and k = 100 on the same
    database through K6 (use_pallas for f32/bf16), held against the plain
    scan (f32/bf16: the database's own XLA-path counterpart; int8: K6's
    plain version, bit for bit); the launch counts must show the tile scan.
    Returns those launch counts."""
    from emr2a_tpu_torch.ops import topk
    from emr2a_tpu_torch.retrieval.database import ShardedEmbeddingDatabase
    from emr2a_tpu_torch.retrieval.database_cli import chained_p50_ms

    rng = np.random.default_rng(0)
    emb = rng.standard_normal((K6_N, K6_DIM), dtype=np.float32)
    query = emb[123] + 0.1 * rng.standard_normal(K6_DIM, dtype=np.float32)
    batch = emb[:64] + 0.1 * rng.standard_normal((64, K6_DIM), dtype=np.float32)
    batched = {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16),
                        ("int8", torch.int8)):
        t0 = time.time()
        db = ShardedEmbeddingDatabase(emb, dtype=dtype, device="cuda:0")
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
        db.use_pallas = name != "int8"
        torch.cuda.synchronize()
        reset_counts()
        got = {k: db.topk(batch, k) for k in (K6_K, 100)}
        torch.cuda.synchronize()
        launches = read_counts()
        kernel = "cosine_topk_fused_int8" if name == "int8" else "cosine_topk_fused"
        check_launches(f"database batched {name}", launches,
                       {kernel: 2, "cosine_topk tile scan": 2})
        q = db._queries(batch, True)
        for k, res in got.items():
            tag = f"database batched topk {name}, 64 queries, k={k} (tile scan)"
            if name == "int8":
                want = topk.cosine_topk_fused_int8_reference(q, db.shards[0], db.scale_shards[0],
                                                             k, db.n)
                if not (torch.equal(res[0], want[0]) and torch.equal(res[1], want[1])):
                    fail(f"{tag}: not bit-identical to the plain version")
                print(f"{tag}: bit-identical to the plain version", flush=True)
            else:
                db.use_pallas = False
                want = db.topk(batch, k)
                db.use_pallas = True
                topk_agrees(tag, res, want, q.float() @ db.shards[0][:db.n].float().T)
            if (res[1][:, 0].cpu() != torch.arange(64, dtype=torch.int32)).any():
                fail(f"{tag}: a query's source row is not its top hit")
        batched[name] = launches
        print(f"database batched {name}: launches {launches}", flush=True)
        del db
        torch.cuda.empty_cache()
    return batched


PROCESS_ROWS = 1 << 20        # the processes phase's rows: one shard a process


def processes_phase(work: Path, card: str) -> dict:
    """Phase 8c (module docstring). Returns each dtype's K6 launches summed
    over the ranks."""
    from concurrent.futures import ThreadPoolExecutor

    from emr2a_tpu_torch.parallel.launch import WorkerFailed, launch
    from emr2a_tpu_torch.retrieval.database import ShardedEmbeddingDatabase
    from emr2a_tpu_torch.tools.db_processes import CHECKS, DTYPES, seeded_rows, write_rows

    t_phase = time.time()
    out = work / "processes"
    emb, batch = seeded_rows(PROCESS_ROWS)
    write_rows(out, emb, batch)
    t_rows = time.time() - t_phase
    ranks_s = []

    def ranks():
        t0 = time.time()
        text = launch(["-m", "emr2a_tpu_torch.tools.db_processes", "--case", "measure",
                       "--one_card", "--no_timings", "--dir", str(out)], 2, timeout=300,
                      cwd=str(Path(__file__).resolve().parent))
        ranks_s.append(time.time() - t0)
        return text

    # the one-process answers on this card while the ranks run
    t0 = time.time()
    with ThreadPoolExecutor(1) as pool:
        running = pool.submit(ranks)
        want = {}
        for name, dtype in DTYPES.items():
            one = ShardedEmbeddingDatabase(emb, dtype=dtype, use_pallas=True, normalize=False,
                                           device="cuda:0")
            want[name] = {f"q{nq}_k{k}": [t.cpu().numpy() for t in one.topk(batch[:nq], k)]
                          for nq, k in CHECKS}
            del one
            torch.cuda.empty_cache()
        t_refs = time.time() - t0
        try:
            text = running.result()
        except WorkerFailed as e:
            fail(f"processes: {e}")
    del emb
    print("\n".join(line for line in text.splitlines() if line.startswith("[default0]:")),
          flush=True)
    records = [json.loads((out / f"rank{r}.json").read_text()) for r in range(2)]
    launches = {}
    for name, dtype in DTYPES.items():
        kernel = "cosine_topk_fused_int8" if name == "int8" else "cosine_topk_fused"
        for r, rec in enumerate(records):
            counts = rec["dtypes"][name]["launches"]
            if counts[kernel] != len(CHECKS):
                fail(f"processes {name}: rank {r} launched {counts} for {len(CHECKS)} searches")
            for key, c in counts.items():
                launches.setdefault(name, {}).setdefault(key, 0)
                launches[name][key] += c
            got = np.load(out / f"rank{r}_{name}.npz")
            for key, (vals, idx) in want[name].items():
                if not np.array_equal(got[f"{key}_idx"], idx):
                    fail(f"processes {name} {key}: rank {r}'s indices differ from one "
                         f"process's")
                if not np.array_equal(got[f"{key}_vals"].view(np.int32), vals.view(np.int32)):
                    fail(f"processes {name} {key}: rank {r}'s values are not bit-identical "
                         f"to one process's")
        print(f"processes {name}: 2 processes on {records[0]['device']} ({PROCESS_ROWS} x "
              f"{K6_DIM}, one shard each, gloo): indices equal one process's at q=1 k=5, q=64 "
              f"k=5 and 100, values bit-identical; K6 launches by rank "
              f"{[rec['dtypes'][name]['launches'] for rec in records]} ({card})", flush=True)
    print(f"processes phase in {time.time() - t_phase:.1f} s (rows made and written "
          f"{t_rows:.1f} s; the ranks {ranks_s[0]:.1f} s under torchrun, beside the "
          f"one-process answers' {t_refs:.1f} s)", flush=True)
    return launches


MESH_SLAB_ROWS = 1 << 18      # rows a slab of the sharded scan's check on one card


def mesh_phase(work: Path, manifest_path: Path, emb_path: Path, card: str) -> dict:
    """The mesh on this card: the database CLI (int8 build + query) under
    ``default_mesh()`` (every visible card; here one, so one shard), and the
    sharded scan's own functions (``shard_topk`` with each slab's ``base``
    and ``n_valid_local``, then ``merge_topk``) over four slabs of a seeded
    (2 x MESH_SLAB_ROWS + 1,000) x 512 database placed on cuda:0 (two full,
    one short, one empty) in f32, bf16 (K6) and int8 (K6's int8 variant) at
    q = 1 and 64, k = 5 and 100; the launch counts read just after; then
    each merged answer against the one-device database's scan of the same
    buffer (indices exact, values compared bit for bit) and the CLI's hits
    against the database phase's. Then step2's CLI ``--encoder_type vit
    --fast`` on 2 patients with ``--data_parallel`` (the default mesh) and
    without, launches and rows equal. Returns the launch counts by path."""
    from emr2a_tpu_torch.encoders.vit_encoder import ViTEncoder
    from emr2a_tpu_torch.ops import topk
    from emr2a_tpu_torch.parallel import default_mesh
    from emr2a_tpu_torch.retrieval import database_cli
    from emr2a_tpu_torch.retrieval.database import (ShardedEmbeddingDatabase, merge_topk,
                                                    shard_topk)

    t_phase = time.time()
    mesh = default_mesh()
    if mesh.shape != {"data": torch.cuda.device_count(), "model": 1}:
        fail(f"mesh: the default mesh is {mesh}")
    S = MESH_SLAB_ROWS
    n = 2 * S + 1000
    rng = np.random.default_rng(16)
    emb = rng.standard_normal((n, K6_DIM), dtype=np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True) + 1e-12
    batch = emb[rng.choice(n, 64, replace=False)] + 0.1 * rng.standard_normal(
        (64, K6_DIM), dtype=np.float32)
    dbs = {name: ShardedEmbeddingDatabase(emb, dtype=dtype, use_pallas=True,
                                          normalize=False, device="cuda:0")
           for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16),
                               ("int8", torch.int8))}
    slabs = {}
    for name, db in dbs.items():
        whole = db.shards[0]
        scales = None if db.scale_shards is None else db.scale_shards[0]
        pads = []
        for i in range(4):
            slab = torch.zeros((S, K6_DIM), dtype=whole.dtype, device="cuda:0")
            sc = None if scales is None else torch.ones(S, device="cuda:0")
            rows = whole[i * S:min((i + 1) * S, n)]
            slab[:rows.shape[0]] = rows
            if sc is not None:
                sc[:rows.shape[0]] = scales[i * S:min((i + 1) * S, n)]
            pads.append((slab, sc))
        slabs[name] = pads
    valid = [min(max(n - i * S, 0), S) for i in range(4)]
    d = work / "mesh_db"
    torch.cuda.synchronize()
    reset_counts()
    database_cli.main(["build", "--embeddings_path", str(emb_path), "--manifest_path",
                       str(manifest_path), "--db", str(d / "db.npz"), "--dtype", "int8"])
    database_cli.main(["query", "--db", str(d / "db.npz"), "--queries_path", str(emb_path),
                       "--k", "5", "--dtype", "int8", "--output", str(d / "hits.jsonl")])
    merged = {}
    for name, db in dbs.items():
        q = db._queries(batch, True)
        for nq, k in ((1, 5), (64, 5), (64, 100)):
            parts = [shard_topk(q[:nq], slab, sc, valid[i], i * S, min(k, S), True)
                     for i, (slab, sc) in enumerate(slabs[name])]
            merged[name, nq, k] = merge_topk(parts, k, q.device)
    torch.cuda.synchronize()
    launches = read_counts()
    cli_queries = len(database_cli._load_cases(emb_path)[0])
    tile = int(cli_queries >= topk.TILE_MIN_Q[2]) + 3 * 2 * 3
    check_launches("mesh database", launches, {
        "cosine_topk_fused": 2 * 3 * 3, "cosine_topk_fused_int8": 1 + 3 * 3,
        "cosine_topk tile scan": tile})
    bits = []
    for (name, nq, k), (vals, idx) in merged.items():
        want = dbs[name].topk(batch[:nq], k)
        if not torch.equal(idx, want[1]):
            fail(f"mesh: the merged scan of 4 slabs (valid rows {valid}) {name} q={nq} "
                 f"k={k}: indices differ from one scan's")
        bits.append(torch.equal(vals, want[0]))
    cli_hits = (d / "hits.jsonl").read_text()
    if cli_hits != (work / "db" / "int8_cuda" / "hits.jsonl").read_text():
        fail("mesh: the database CLI on the default mesh wrote other hits than the "
             "database phase's")
    print(f"mesh: 4 slabs of {S} rows on cuda:0 (valid rows {valid}), shard_topk + merge_topk "
          f"in f32, bf16, int8 at q = 1 and 64, k = 5 and 100: indices equal one scan's, "
          f"values bit-identical in {sum(bits)} of {len(bits)}; database CLI on the default "
          f"mesh ({mesh.shape['data']} shard): hits equal the database phase's; launches "
          f"{nonzero(launches)} ({card})", flush=True)
    del dbs, slabs, merged
    torch.cuda.empty_cache()

    two = work / "mesh_manifest.jsonl"
    two.write_text("".join(manifest_path.read_text(encoding="utf-8").splitlines(True)[:2]),
                   encoding="utf-8")
    plain = ViTEncoder(device="cpu")
    blocks = 12 * 4                      # 12 blocks x 4 device batches (2 patients x 40 at 32)
    want = {"fused_ln_mlp": blocks, "fused_ln_attention": blocks}
    runs = {}
    for tag, extra in (("vit --fast", []), ("vit --fast --data_parallel", ["--data_parallel"])):
        enc, runs[tag] = zoo_step2_run(
            f"mesh {tag}", ["--encoder_type", "vit", "--fast", *extra], two,
            work / "mesh" / tag.replace(" ", "_"), want, 768, plain,
            "the f32 plain tower on the CPU", card)
        if extra and enc.mesh is not mesh:
            fail("mesh: step2 --data_parallel did not encode over the default mesh")
        del enc
    a, b = (np.load(work / "mesh" / t.replace(" ", "_") / "embeddings.npz") for t in runs)
    if a.files != b.files or not all(np.array_equal(a[p], b[p]) for p in a.files):
        fail("mesh: step2 --data_parallel wrote other rows than step2 without it")
    print(f"mesh: step2 --data_parallel on the default mesh ({mesh.shape['data']} card) wrote "
          f"the rows step2 without it writes; mesh phase in {time.time() - t_phase:.1f} s "
          f"({card})", flush=True)
    return {"mesh database": launches,
            "step2 vit --fast --data_parallel": runs["vit --fast --data_parallel"]}


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


# -- the encoder zoo: step2's encoder types at full width ---------------------

ZOO_SLICES = 8               # slices of the first patient held against the CPU
CLIP_L_BATCH, DINO_BATCH = 8, 16
# openai/clip-vit-large-patch14-336's text tower
CLIP_L_TEXT = dict(vocab_size=49408, max_length=77, hidden_size=768, num_layers=12,
                   num_heads=12, mlp_dim=3072, activation="quick_gelu", eos_token_id=49407)


class ClipCharTokenizer:
    """A stub CLIP BPE tokenizer: <|startoftext|> 49406, one id per
    character, <|endoftext|> 49407, padded with 49407 to ``max_length``.
    Nothing is downloaded."""

    def __call__(self, texts, max_length=77, **kw):
        ids = np.full((len(texts), max_length), 49407, np.int64)
        for i, t in enumerate(texts):
            toks = [49406] + [1 + ord(c) % 49000 for c in t[:max_length - 2]] + [49407]
            ids[i, :len(toks)] = toks
        return {"input_ids": ids, "attention_mask": (ids != 49407).astype(np.int64)}


def hold(tag: str, got, want, limit: float = 0.999, what: str = "") -> float:
    """Row cosines of ``got`` against ``want``; fail below ``limit``."""
    cos = cosines(np.stack(got), np.stack(want))
    if not np.isfinite(cos).all() or cos.min() < limit:
        fail(f"{tag}: disagrees with {what}: cosine {cos}")
    return float(cos.min())


def tower_throughput(tag: str, encoder, batch: int, card: str) -> float:
    """Slices/s of ``encoder``'s image tower at ``batch`` on seeded pixels
    (median of 20 forwards, CUDA events), and the device time of one
    forward by kernel (``torch.profiler``: the six largest, and the sum's
    share of the forward)."""
    from emr2a_tpu_torch.ops.preprocess import preprocess_images
    from emr2a_tpu_torch.tools.time_blocks import device_breakdown
    size = encoder.preprocess.resize_size if not encoder.preprocess.shortest_edge \
        else encoder.preprocess.crop_size
    u8 = torch.randint(0, 256, (batch, size, size, 3), dtype=torch.uint8, device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(2))
    with torch.inference_mode():
        pixels = preprocess_images(u8, encoder.preprocess)
        forward = lambda: encoder.image_model(pixels)
        ms = median_ms(forward, iters=20)
        by_kernel = device_breakdown(forward, calls=3)
    rate = batch / ms * 1e3
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
    print(f"tower throughput {tag}: {rate:.1f} slices/s at batch {batch}, median {ms:.3f} ms "
          f"a batch; device ms a forward {sum(by_kernel.values()):.3f} (busy share "
          f"{sum(by_kernel.values()) / ms:.2f}), largest: "
          + ", ".join(f"{k[:60]} {v:.3f}" for k, v in top) + f" ({card})", flush=True)
    return rate


def zoo_step2_run(tag: str, args: list, manifest_path: Path, out_dir: Path, want: dict,
                  dim: int, plain, limit_what: str, card: str, n_compare: int = ZOO_SLICES):
    """step2's CLI (``build_embeddings.main``) with ``args`` on the cohort:
    the launch counts, read just after, equal ``want`` (every block of every
    device batch) and 0 for every other kernel; the artifacts; the first
    patient's first slices against ``plain`` (the same random weights on the
    CPU). Returns (the encoder step2 built, its launches)."""
    from emr2a_tpu_torch.pipelines.step2_embeddings import build_embeddings as step2

    built = []
    make = step2.create_encoder
    step2.create_encoder = lambda *a, **k: built.append(make(*a, **k)) or built[-1]
    try:
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.time()
        step2.main(["--manifest_path", str(manifest_path), "--output_dir", str(out_dir),
                    "--device", "cuda", *args])
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = read_counts()
    finally:
        step2.create_encoder = make
    check_launches(f"step2 {tag}", launches, want)
    npz = np.load(out_dir / "embeddings.npz")
    meta = json.loads((out_dir / "embeddings_meta.json").read_text())
    if meta["embedding_dim"] != dim or len(npz.files) != meta["num_patients"]:
        fail(f"step2 {tag}: meta {meta}")
    for pid in npz.files:
        e = npz[pid]
        if e.shape != (40, dim) or not np.isfinite(e).all():
            fail(f"step2 {tag} {pid}: embeddings {e.shape}, finite={np.isfinite(e).all()}")
    first = [Path(p) for p in json.loads(manifest_path.read_text(encoding="utf-8")
                                         .splitlines()[0])["slices"][:n_compare]]
    cos = hold(f"step2 {tag}", list(npz[npz.files[0]][:n_compare]),
               list(plain.encode_images(first)), what=limit_what)
    print(f"step2 {' '.join(args)}: {len(npz.files)} patients x 40 slices in {wall:.2f} s "
          f"(encoder build and host decode included); launches {launches}; first "
          f"{n_compare} slices vs {limit_what}: min cosine {cos:.6f} ({card})", flush=True)
    return built[0], launches


def vit_zoo_phase(work: Path, manifest_path: Path, card: str) -> dict:
    """step2's default ``--encoder_type vit`` (timm ViT-B/16, random weights
    from seed 0) three ways: plain f32 (no kernel), ``--fast`` (K1 + K3 on
    every block) and ``--fast int8`` (K2 + K4)."""
    from emr2a_tpu_torch.encoders.vit_encoder import ViTEncoder

    plain = ViTEncoder(device="cpu")
    cfg = plain.image_model.config
    if not (cfg.hidden_size == 768 and cfg.num_layers == 12 and cfg.mlp_dim == 3072
            and cfg.pooling == "avg_fc_norm"):
        fail("step2's vit is not timm ViT-B/16")
    blocks = 12 * 24                     # 12 blocks x 24 device batches (12 patients x 2)
    runs = {}
    for tag, args, want in (
            ("vit", [], {}),
            ("vit --fast", ["--fast"], {"fused_ln_mlp": blocks, "fused_ln_attention": blocks}),
            ("vit --fast int8", ["--fast", "int8"],
             {"fused_ln_mlp_int8": blocks, "fused_ln_attention_int8": blocks})):
        enc, runs["step2 " + tag] = zoo_step2_run(
            tag, ["--encoder_type", "vit", *args], manifest_path,
            work / "zoo" / tag.replace(" ", "_"), want, 768, plain,
            "the f32 plain tower on the CPU", card)
        tower_throughput(f"step2 {tag} (timm ViT-B/16)", enc, 32, card)
        del enc
    return runs


def clip_zoo_phase(image_paths: dict, card: str) -> dict:
    """CLIP at openai/clip-vit-large-patch14-336's geometry (random weights
    from seed 0, the stub tokenizer) with ``fast="int8"`` and ``fast=True``
    on one device batch of 8 slices and 16 texts; then CLIP ViT-B/16's
    12-block vision tower with ``fast=True`` on a batch of 32."""
    import dataclasses as dc

    from emr2a_tpu_torch.encoders.clip_encoder import CLIPEncoder
    from emr2a_tpu_torch.models.clip import CLIPConfig
    from emr2a_tpu_torch.models.text import CLIPTextConfig
    from emr2a_tpu_torch.models.vit import CLIP_VIT_B16_VISION, CLIP_VIT_L14_336_VISION

    tok = ClipCharTokenizer()
    paths = next(iter(image_paths.values()))
    texts = clinical_texts(16)
    cfg = CLIPConfig(vision=CLIP_VIT_L14_336_VISION, text=CLIPTextConfig(**CLIP_L_TEXT),
                     projection_dim=768)
    t0 = time.time()
    cpu = CLIPEncoder.random_init(cfg, tokenizer=tok, seed=0, device="cpu")
    params = {"image": cpu.image_model.state_dict(), "text": cpu.text_model.state_dict()}
    int8_cpu = CLIPEncoder(config=cfg, params=params, tokenizer=tok, device="cpu", fast="int8")
    want_f32 = {"image": cpu.encode_images(paths[:2]), "text": cpu.encode_batch_texts(texts[:8])}
    want_int8 = {"image": int8_cpu.encode_images(paths[:2]),
                 "text": int8_cpu.encode_batch_texts(texts[:8])}
    print(f"CLIP ViT-L/14-336 (vision 1024 x 24, 16 heads, MLP 4096, 336 px, patch 14; text "
          f"768 x 12, context 77, vocab 49,408; projection 768; quick_gelu): random weights "
          f"(seed 0) and the CPU's f32 and int8 plain towers in {time.time() - t0:.1f} s",
          flush=True)
    runs = {}
    n_layers, n_text = cfg.vision.num_layers, cfg.text.num_layers
    for tag, fast in (("int8", "int8"), ("bf16", True)):
        enc = CLIPEncoder(config=cfg, params=params, tokenizer=tok, device="cuda", fast=fast,
                          max_batch=CLIP_L_BATCH)
        for what, run, want in (
                ("image", lambda: enc.encode_images(paths[:CLIP_L_BATCH]),
                 {"fused_ln_mlp_int8": n_layers, "linear_w8a8": 4 * n_layers}
                 if fast == "int8" else {}),
                ("text", lambda: enc.encode_batch_texts(texts),
                 {"linear_w8a8": 6 * n_text * -(-len(texts) // CLIP_L_BATCH)}
                 if fast == "int8" else {})):
            torch.cuda.synchronize()
            reset_counts()
            got = run()
            torch.cuda.synchronize()
            launches = read_counts()
            check_launches(f"clip ViT-L/14-336 {tag} {what}", launches, want)
            runs[f"clip ViT-L/14-336 {tag} {what}"] = launches
            ref = (want_int8 if fast == "int8" else want_f32)[what]
            cos = hold(f"clip {tag} {what}", list(got[:len(ref)]), list(ref),
                       what=f"the {'int8' if fast == 'int8' else 'f32'} plain tower on the CPU")
            cos32 = cosines(np.stack(got[:len(ref)]), np.stack(want_f32[what])).min()
            print(f"clip ViT-L/14-336 fast={fast!r} {what}: {len(got)} rows "
                  f"{np.stack(got).shape}; launches {launches}; min cosine {cos:.6f} against "
                  f"the CPU's {'int8' if fast == 'int8' else 'f32'} plain tower, {cos32:.6f} "
                  f"against f32 ({card})", flush=True)
        tower_throughput(f"CLIP ViT-L/14-336 fast={fast!r}", enc, CLIP_L_BATCH, card)
        del enc
    del cpu, int8_cpu, params
    # K1's quick_gelu epilogue on a real path: CLIP ViT-B/16's whole vision
    # tower (its text tower is cut to one layer and not run)
    b16 = CLIPConfig(vision=CLIP_VIT_B16_VISION, text=CLIPTextConfig(num_layers=1),
                     projection_dim=512)
    n_b16 = b16.vision.num_layers
    cpu = CLIPEncoder.random_init(b16, seed=0, device="cpu")
    params = {"image": cpu.image_model.state_dict(), "text": cpu.text_model.state_dict()}
    enc = CLIPEncoder(config=b16, params=params, device="cuda", fast=True, max_batch=32)
    torch.cuda.synchronize()
    reset_counts()
    got = enc.encode_images(paths[:32])
    torch.cuda.synchronize()
    launches = read_counts()
    check_launches("clip ViT-B/16 fast", launches,
                   {"fused_ln_mlp": n_b16, "fused_ln_attention": n_b16})
    runs["clip ViT-B/16 fast"] = launches
    cos = hold("clip ViT-B/16 fast", list(got[:ZOO_SLICES]),
               list(cpu.encode_images(paths[:ZOO_SLICES])), what="the f32 plain tower")
    print(f"clip ViT-B/16 vision, {n_b16} blocks, fast=True: 32 slices, launches {launches} (K1 "
          f"with quick_gelu, K3); min cosine {cos:.6f} against the f32 plain tower on the CPU "
          f"({card})", flush=True)
    tower_throughput("CLIP ViT-B/16 fast=True", enc, 32, card)
    return runs


def dino_zoo_phase(work: Path, manifest_path: Path, card: str) -> dict:
    """step2 ``--encoder_type dino`` (DINOv3 ViT-L/16, 4 registers, random
    weights from seed 0) with ``--fast`` (bf16, no fused path) and ``--fast
    int8`` (every block projection on K5) at batch 16."""
    from emr2a_tpu_torch.encoders.dino_encoder import DINOEncoder

    t0 = time.time()
    plain = DINOEncoder(device="cpu")
    cfg = plain.config
    if not (cfg.hidden_size == 1024 and cfg.num_layers == 24 and cfg.num_heads == 16
            and cfg.num_register_tokens == 4 and cfg.rope_theta == 100.0):
        fail("step2's dino is not DINOv3 ViT-L/16")
    int8_plain = DINOEncoder(device="cpu", fast="int8",
                             params=plain.image_model.state_dict())
    print(f"DINOv3 ViT-L/16 CPU f32 and int8 plain towers in {time.time() - t0:.1f} s",
          flush=True)
    from emr2a_tpu_torch.data import native_loader

    batches = 12 * -(-40 // DINO_BATCH)
    runs = {}
    for tag, args, want, ref in (
            ("dino --fast", ["--fast"], {}, (plain, "the f32 plain tower on the CPU")),
            ("dino --fast int8", ["--fast", "int8"],
             {"linear_w8a8": 6 * cfg.num_layers * batches},
             (int8_plain, "the int8 plain tower on the CPU"))):
        pool_before = native_loader.POOL_BATCHES
        enc, runs["step2 " + tag] = zoo_step2_run(
            tag, ["--encoder_type", "dino", "--batch_size", str(DINO_BATCH), *args],
            manifest_path, work / "zoo" / tag.replace(" ", "_"), want, 1024, *ref, card,
            n_compare=4)
        pooled = native_loader.POOL_BATCHES - pool_before
        # DINOv3's exact 224 x 224 resize decodes on the pool, as in JAX: every
        # device batch of step2 and of the CPU reference
        if pooled < batches:
            fail(f"step2 {tag}: {pooled} decode pool batches, expected at least {batches}")
        print(f"step2 {tag}: {pooled} decode pool batches (step2's {batches} and the CPU "
              f"reference's)", flush=True)
        tower_throughput(f"step2 {tag} (DINOv3 ViT-L/16)", enc, DINO_BATCH, card)
        del enc
    return runs


def quick_gelu_epilogue_check() -> dict:
    """K1's and K2's quick_gelu epilogues, as ``gelu_epilogue_check``: fc1
    weights zero and b1 = the 400,000 values, so that the h1 scratch is the
    epilogue's activation of them. The bf16 epilogues (flags 3) against the
    ``quick_gelu_bf16`` device function (``emr2a_activation_values``) bit for
    bit, and that device function against the plain version within one bf16
    ulp; the f32 epilogues (flags 2) against ``x * torch.sigmoid(1.702 x)``:
    K2's f32 h1 within 2^-20 relative, K1's bf16-rounded h1 within one bf16
    ulp. These calls bypass the wrappers and their launch counts."""
    import ctypes
    from emr2a_tpu_torch.ops import _build, mlp

    v = torch.from_numpy((np.random.RandomState(3).randn(GELU_VALUES) * 3)
                         .astype(np.float32)).to(torch.bfloat16)
    T, d, m = 8, 128, GELU_VALUES
    dev, bf = torch.device("cuda"), torch.bfloat16
    x = torch.randn(T, d, device=dev).to(bf)
    ln_s, ln_b = torch.ones(d, device=dev, dtype=bf), torch.zeros(d, device=dev, dtype=bf)
    b1, b2 = v.to(dev), torch.zeros(d, device=dev, dtype=bf)
    stream = torch.cuda.current_stream().cuda_stream
    p, i = ctypes.c_void_p, ctypes.c_int
    ptrs = lambda *ts: [t.data_ptr() for t in ts]
    k1 = _build.kernel_function("emr2a_fused_ln_mlp", mlp._argtypes())
    k2 = _build.kernel_function("emr2a_fused_ln_mlp_int8",
                                [p] * 15 + [i, i, i, i, ctypes.c_float, p])
    values = _build.kernel_function("emr2a_activation_values", [p, p, i, i, p])
    w1, w2 = torch.zeros(d, m, device=dev, dtype=bf), torch.zeros(m, d, device=dev, dtype=bf)
    w1q, w2q = w1.to(torch.int8), w2.to(torch.int8)
    w1s, w2s = torch.ones(m, device=dev), torch.ones(d, device=dev)
    vf = v.float()
    out = {}
    for act in (3, 2):
        h1, h1_8 = torch.empty(T, m, device=dev, dtype=bf), torch.empty(T, m, device=dev)
        _build.check(k1(*ptrs(x, ln_s, ln_b, w1, b1, w2, b2, h1, torch.empty_like(x)),
                        T, d, m, act, 1e-6, stream), "fused_ln_mlp")
        scratch = (torch.empty(T, d, device=dev, dtype=torch.int8), torch.empty(T, device=dev),
                   h1_8, torch.empty(T, m, device=dev, dtype=torch.int8),
                   torch.empty(T, device=dev), torch.empty_like(x))
        _build.check(k2(*ptrs(x, ln_s, ln_b, w1q, w1s, b1, w2q, w2s, b2, *scratch),
                        T, d, m, act, 1e-6, stream), "fused_ln_mlp_int8")
        fn, b1_f32 = torch.empty(m, device=dev), b1.float()
        _build.check(values(b1_f32.data_ptr(), fn.data_ptr(), m, act, stream),
                     "activation_values")
        torch.cuda.synchronize()
        h1, h1_8, fn = h1.cpu().float(), h1_8.cpu(), fn.cpu()
        if act == 3:
            bad = (h1 != fn.to(bf).float()).sum().item() + (h1_8 != fn).sum().item()
            if bad:
                fail(f"act_dtype=bf16 quick_gelu: the epilogues differ from the device "
                     f"function at {bad} values")
            plain = mlp.quick_gelu_bf16(vf)
            diff = (fn != plain).sum().item()
            ulp = ((fn - plain).abs() / plain.abs().clamp_min(1e-30)).max().item()
            if ulp > 2 ** -7:
                fail(f"quick_gelu_bf16 on the card differs from the plain version by {ulp}")
            out["bf16_device_function_vs_plain_values_differing"] = diff
            print(f"fused_ln_mlp / fused_ln_mlp_int8 act_dtype=bf16 quick_gelu: epilogues "
                  f"bit-identical to the quick_gelu_bf16 device function on {GELU_VALUES} "
                  f"values x {T} rows; that function differs from the plain version at "
                  f"{diff} values (max relative {ulp:.3g}, within one bf16 ulp)", flush=True)
        else:
            plain = vf * torch.sigmoid(1.702 * vf)
            rel = ((h1_8 - plain).abs() / plain.abs().clamp_min(2 ** -20)).max().item()
            k1_diff = (h1 != plain.to(bf).float()).sum().item()
            k1_rel = ((h1 - plain.to(bf).float()).abs()
                      / plain.to(bf).float().abs().clamp_min(2 ** -20)).max().item()
            if rel > 2 ** -20 or k1_rel > 2 ** -7:
                fail(f"f32 quick_gelu epilogues: relative error {rel} (K2), {k1_rel} (K1)")
            out["f32_k2_max_rel_err"], out["f32_k1_values_differing"] = rel, k1_diff
            print(f"fused_ln_mlp_int8 f32 quick_gelu epilogue: max relative error {rel:.3g} "
                  f"against x * sigmoid(1.702 x) (limit 2^-20); fused_ln_mlp's bf16-rounded "
                  f"one differs at {k1_diff} of {GELU_VALUES} values, within one bf16 ulp",
                  flush=True)
    return out


# -- the step4 judge: Qwen3-VL-8B with K7, K8 (and K5) ------------------------

DECODE_TOKENS = 32          # timed decode steps per precision
# Reduced-depth check, card against CPU, last-position logits. bf16: the two
# devices round bf16 products in other orders (about one bf16 ulp of
# relative noise). int8 / int4: that noise flips an s8 activation code
# wherever a value lies within it of a rounding boundary (a few per cent of
# the codes at a step of amax/127), each flip one quantization step, so the
# agreement is looser. The limits sit three to five times outside the
# readings they were set from (NVIDIA H100 80GB HBM3, 700 W: cosine
# 0.999957 / 0.999042 / 0.999150, max abs error 0.055 / 0.25 / 0.24, the
# CPU's logits within +-5.7), and each must refuse a control: the
# card's logits against the CPU's of another precision (an int8 decoder
# where bf16 is expected, int4 where int8 is, int8 where int4 is), which the
# check also runs. The card against every CPU precision is printed.
# int4_awq is int4 on folded weights: int4's limits and control.
MIN_LOGIT_COSINE = {"bf16": 0.9998, "int8": 0.997, "int4": 0.997, "int4_awq": 0.997}
MAX_LOGIT_ABS_ERR = {"bf16": 0.2, "int8": 0.75, "int4": 0.75, "int4_awq": 0.75}
CONTROL_OF = {"bf16": "int8", "int8": "int4", "int4": "int8", "int4_awq": "int8"}
REDUCED_PRECISIONS = ("bf16", "int8", "int4", "int4_awq")
DECODER_KERNEL = {"int8": "linear_w8a8", "int4": "linear_w4a8", "int4_awq": "linear_w4a8"}
STEP4_CASES, STEP4_NEW_TOKENS = 4, 64
OPTION_CHUNK = 512           # the chunked prefill's chunk: 4 chunks of the 2,048 bucket
SAMPLED_TOKENS, SAMPLED_SEED = 16, 1234
REVIEW_SAMPLES = 2
CAPPED_NEW_TOKENS = 32   # CappedBackend's cap: of the review's 512, the VLM baseline's 2,048


# K7 at the speculative phase's token counts: a B = 1 verify of k + 1 = 5
# tokens (the GEMV, up to 16 rows) and 8 slots of 5 (T = 40: the wgmma
# GEMM, whose tiles were tuned for T = 2,048), at the 8B's four shapes
SPEC_LINEAR_T = (5, 40)
SPEC_LINEAR_SHAPES = [(T, K, N) for T in SPEC_LINEAR_T
                      for K, N in ((4096, 4096), (4096, 1024), (4096, 12288), (12288, 4096))]
K7_AT = {}      # T -> K7's chained ms summed over the four shapes


def judge_kernel_phase(card: str) -> list:
    """K7 at the 8B projection shapes, the card's weight quantizers, K8 at
    the judge's vision shape and K9 at ViT-B."""
    from emr2a_tpu_torch.models.quantize import quantize_weight_int8_torch
    from emr2a_tpu_torch.ops import attention, linear_int4, mlp, vision_flash

    g = torch.Generator(device="cuda").manual_seed(4)

    def rn(*shape, std=1.0):
        return (torch.randn(*shape, generator=g, device="cuda") * std).to(torch.bfloat16)

    # the card's quantizers give the numpy recipes' bytes
    w = rn(4096, 12288, std=0.02).float()
    wp, ws = linear_int4.quantize_weight_int4_torch(w)
    np_p, np_s = linear_int4.quantize_weight_int4(w.cpu().numpy())
    q8, s8 = quantize_weight_int8_torch(w)
    np_q8, np_s8 = mlp.quantize_weight_int8(w.cpu().numpy())
    if not (np.array_equal(wp.cpu().numpy(), np_p) and np.array_equal(ws.cpu().numpy(), np_s)
            and np.array_equal(q8.cpu().numpy(), np_q8)
            and np.array_equal(s8.cpu().numpy(), np_s8)):
        fail("the card's weight quantizers differ from the numpy recipes")
    print("quantize_weight_int4/int8 on the card: bytes equal the numpy "
          "recipes' (4096 x 12288)", flush=True)
    del w, wp, ws, q8, s8
    records = [linear_record("k7", card, extra=SPEC_LINEAR_SHAPES)]
    for T in SPEC_LINEAR_T:
        rows = [r for r in records[0]["shapes"] if r["T"] == T]
        K7_AT[T] = sum(r["chained_ms"] for r in rows)
        parts = ", ".join("%s %.4f" % (r["shape"], r["chained_ms"]) for r in rows)
        print(f"linear_w4a8 at T = {T} (a speculative verify, "
              f"{'B = 1, k = 4' if T == 5 else '8 slots x (k + 1)'}; the "
              f"{'GEMV' if T <= 16 else 'wgmma GEMM'} path): {K7_AT[T]:.4f} ms chained for "
              f"one decoder layer's four projection shapes ({parts}) ({card})", flush=True)

    sdpa = torch.nn.functional.scaled_dot_product_attention

    def attention_record(name, module, shape, replaces) -> dict:
        F_, S, H, hd = shape
        q, k, v = (rn(*shape) for _ in range(3))
        scale = hd ** -0.5
        if module is vision_flash:
            fn = lambda: vision_flash.frame_flash_attention(q, k, v, scale)
            ref = lambda: vision_flash.frame_flash_attention_reference(q, k, v, scale)
        else:
            fn = lambda: attention.fused_attention(q, k, v)
            ref = lambda: attention.fused_attention_reference(q, k, v)
        got = fn()
        torch.cuda.synchronize()
        err = compare(f"{name} {shape}", got, ref())
        rec = {"name": name, "route": "cuda",
               "source": "emr2a_tpu_torch/csrc/frame_attention.cu",
               "replaces": replaces, "shape": f"(F|B, S, H, hd) = {shape}",
               "max_abs_err": err, **timings(fn), "plain_ms": median_ms(ref),
               **bound(4 * nbytes(q), [("bf16", 4 * F_ * H * S * S * hd)])}
        lib = timings(lambda: sdpa(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), scale=scale))
        rec.update({"library_ms": lib["ms"], "library_chained_ms": lib["chained_ms"]})
        print(f"{name} {shape}: kernel {timing_text(rec)}, plain version "
              f"{rec['plain_ms']:.4f} ms, scaled_dot_product_attention "
              f"{timing_text(lib)}, bound {rec['bound_ms']:.4f} ms "
              f"({rec['bound_by']}) (medians of 100; {card})", flush=True)
        return rec

    k8 = attention_record("frame_flash_attention", vision_flash, (7, 1024, 16, 72),
                          "emr2a_tpu/ops/vision_flash.py:76")
    # the VLM direct baseline's requests carry 4 slices, not the audit's 7
    k8["vlm_direct_shape"] = {
        key: value for key, value in attention_record(
            "frame_flash_attention", vision_flash, (4, 1024, 16, 72),
            "emr2a_tpu/ops/vision_flash.py:76").items()
        if key not in ("name", "route", "source", "replaces")}
    records.append(k8)
    records.append(attention_record("fused_attention", attention, (32, 197, 12, 64),
                                    "emr2a_tpu/ops/attention.py:61"))
    # K10 at the judge cells' decode shapes (tools/time_decode_attention)
    records.extend(decode_records(card))
    torch.cuda.empty_cache()
    return records


class ForwardCount:
    """``module``'s forwards since this count began, read as ``.n``: its
    eager calls (a pre-hook, which ignores the calls a CUDA graph capture
    makes: they launch nothing) plus the forwards that graph replays ran
    (``models/cuda_graph.replayed_forwards``). ``.narrow``: those of at most
    ``decode_attention.MAX_QUERIES`` positions (the decoder's decode steps,
    which K10 attends; the replayed steps are all decode steps)."""

    def __init__(self, module):
        from emr2a_tpu_torch.models.cuda_graph import replayed_forwards
        self.module, self.eager, self.eager_narrow = module, 0, 0
        self.base = replayed_forwards(module)
        self.hook = module.register_forward_pre_hook(self._seen)

    def _seen(self, module, args):
        if not torch.cuda.is_current_stream_capturing():
            self.eager += 1
            self.eager_narrow += int(args[0].dim() > 1
                                     and args[0].shape[1] <= decode_attention.MAX_QUERIES)

    @property
    def n(self) -> int:
        from emr2a_tpu_torch.models.cuda_graph import replayed_forwards
        return self.eager + replayed_forwards(self.module) - self.base

    @property
    def narrow(self) -> int:
        return self.n - self.eager + self.eager_narrow

    def remove(self) -> None:
        self.hook.remove()


def k10_launches(model, n_text: ForwardCount, kv_dtype: str) -> int:
    """K10's launches over ``n_text``'s forwards of ``model``'s decoder: one
    a layer each forward of at most MAX_QUERIES positions over a bf16 KV
    cache, none over the int8 cache (its plain path)."""
    return len(model.language_model.layers) * n_text.narrow if kv_dtype == "bf16" else 0


def nonzero(launches: dict) -> dict:
    return {k: v for k, v in launches.items() if v}


def check_launches(tag: str, launches: dict, want: dict) -> None:
    for name, n in launches.items():
        if n != want.get(name, 0):
            fail(f"{tag}: {name} launched {n} times, expected {want.get(name, 0)}")


def judge_bounds(model, prec: str, padded: int, grids, max_len: int) -> dict:
    """The least time the card could take for one prefill of ``padded``
    tokens (operations: vision tower, decoder projections in their type,
    causal attention, the last position's logits) and for one decode step
    (bytes: the decoder's weights but the embedding table, once, and the
    KV cache up to ``max_len``)."""
    v, t = model.config.vision, model.config.text
    d, hd, L, I = t.hidden_size, t.head_dim, t.num_layers, t.intermediate_size
    nq, nkv = t.num_heads * hd, t.num_kv_heads * hd
    proj = L * (d * (nq + 2 * nkv) + nq * d + 3 * d * I)
    T_v = sum(a * b * c for a, b, c in grids)
    seq_f = grids[0][1] * grids[0][2]
    dv, m4 = v.hidden_size, v.hidden_size * v.spatial_merge_size ** 2
    vision = (2 * T_v * v.patch_dim * dv
              + v.depth * (2 * T_v * (4 * dv * dv + 2 * dv * v.intermediate_size)
                           + 4 * T_v * seq_f * dv)
              + (1 + len(v.deepstack_visual_indexes)) * 2 * (T_v // 4) * m4 * (m4 + v.out_hidden_size))
    attention = L * 4 * t.num_heads * hd * padded * (padded + 1) // 2
    kind = "bf16" if prec == "bf16" else "int8"
    ops = [("bf16", vision + attention + 2 * d * t.vocab_size), (kind, 2 * padded * proj)]
    lm = {x.data_ptr(): x for name, x in model.language_model.state_dict().items()
          if not name.startswith("embed_tokens")}
    cache = L * 2 * max_len * nkv * 2
    return {"prefill": bound(nbytes(*model.state_dict().values()), ops),
            "decode": bound(nbytes(*lm.values()) + cache)}


def decode_timings(gen, state, steps: int, tag: str, per_step: dict) -> dict:
    """``steps`` decode steps from ``state`` (a ``DecodeState`` with room
    for 2 * steps + 1), eagerly and replayed from a CUDA graph (the
    generator's path), each timed with CUDA events from the same start
    (the step counter, tokens and done flags put back; the KV rows the
    steps rewrite get the same values): the tokens must be equal and one
    more replayed step must equal the same step run eagerly on a copy of
    the state, bit for bit (``cuda_graph.replay_matches_eager``). Launches
    a token: the kernels of one profiled eager step (a replay launches the
    same ones); busy share: the profiled device time of the replayed steps
    over their wall (the eager step's device time where the profiler does
    not see a graph's kernels)."""
    from torch.profiler import ProfilerActivity, profile

    from emr2a_tpu_torch.models.cuda_graph import StepGraph, replay_matches_eager
    from emr2a_tpu_torch.tools.profile_judge import _self_device_us
    token0, done0 = state.token.clone(), state.done.clone()

    def reset():
        state.step.zero_()
        state.token.copy_(token0)
        state.done.copy_(done0)

    def timed(run) -> float:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        reset()
        torch.cuda.synchronize()
        ev[0].record()
        run()
        ev[1].record()
        ev[1].synchronize()
        return ev[0].elapsed_time(ev[1]) / steps

    def eager():
        for _ in range(steps):
            gen.decode_step(state)

    # ``per_step``: each kernel's launches a step, eager and replayed
    reset_counts()
    eager_ms = timed(eager)
    check_launches(f"judge {tag} {steps} eager steps", read_counts(),
                   {k: n * steps for k, n in per_step.items()})
    eager_tokens = state.out[:, :steps].clone()
    runner = StepGraph(gen.decode_step, state, state.token.device)
    reset()
    reset_counts()
    runner.run(2)                       # the warm-up, the capture, one replay
    graph_ms = timed(lambda: runner.run(steps))
    check_launches(f"judge {tag} a warm-up step, a capture and {steps + 1} replays",
                   read_counts(), {k: n * (steps + 2) for k, n in per_step.items()})
    if not torch.equal(state.out[:, :steps], eager_tokens):
        fail(f"judge {tag}: the graph's tokens differ from the eager steps'")
    diffs = replay_matches_eager(runner)
    if diffs:
        fail(f"judge {tag}: a replayed decode step differs from the eager step in {diffs}")

    def device_ms(prof) -> tuple:
        us = [(_self_device_us(e), e.count) for e in prof.key_averages()]
        return sum(u for u, _ in us if u > 0) / 1e3, sum(n for u, n in us if u > 0)

    reset()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        gen.decode_step(state)
        torch.cuda.synchronize()
    step_device_ms, launches = device_ms(prof)
    reset()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        runner.run(steps)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    graph_device_ms = device_ms(prof)[0]
    traced = graph_device_ms > 0
    busy = (graph_device_ms if traced else step_device_ms * steps) / wall
    out = {"eager_ms": eager_ms, "graph_ms": graph_ms, "capture_ms": runner.capture_ms,
           "launches_per_token": launches,
           "step_device_ms": step_device_ms, "busy_share": busy,
           "busy_from": "graph replays" if traced else "eager step's device time",
           "bit_identical": True}
    print(f"judge {tag} decode at B = 1: eager {eager_ms:.3f} ms/step, CUDA graph "
          f"{graph_ms:.3f} ms/step (CUDA events, {steps} steps each, equal tokens; the "
          f"warm-up step and capture {runner.capture_ms:.1f} ms, host clock; one "
          f"replayed step equal to the eager step bit for bit: cache, logits, tokens); "
          f"{launches} kernel launches a token; device {step_device_ms:.3f} ms a step; "
          f"busy share of the replayed steps {busy:.3f} (from the {out['busy_from']})",
          flush=True)
    return out


def decode_step_kernels(step) -> dict:
    """The K5 / K7 wrapper calls one call of ``step`` (a decode step) makes,
    and the device launches their kernel library issues for them, by kind
    (``ops/linear_int8.device_launches``)."""
    from emr2a_tpu_torch.ops import linear_int4, linear_int8
    torch.cuda.synchronize()
    calls = linear_int8.LAUNCHES, linear_int4.LAUNCHES
    before = linear_int8.device_launches()
    step()
    torch.cuda.synchronize()
    after = linear_int8.device_launches()
    return {"linear_w8a8 calls": linear_int8.LAUNCHES - calls[0],
            "linear_w4a8 calls": linear_int4.LAUNCHES - calls[1],
            **{kind: after[kind] - before[kind] for kind in after}}


def judge_request(prec: str, backend, request: dict, card: str, tag: str = None) -> dict:
    """One audit request through ``backend.generate`` with the counts reset
    just before; then prefill and decode timed with CUDA events. ``tag``
    names a run with generator options (``prec`` is its weights')."""
    tag = tag or prec
    gen = backend.generator
    model = backend.model
    n_text = ForwardCount(model.language_model)
    n_vis = ForwardCount(model.visual)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.time()
    text = backend.generate(request["images"], request["prompt"],
                            system=request["system"], max_new_tokens=DECODE_TOKENS)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    n_text.remove()
    n_vis.remove()
    n_proj = 7 * len(model.language_model.layers)
    kernel = {"int8": "linear_w8a8", "int4": "linear_w4a8"}.get(prec)
    want = {"frame_flash_attention": len(model.visual.blocks) * n_vis.n,
            "decode_attention": k10_launches(model, n_text, gen.kv_dtype)}
    if kernel:
        want[kernel] = n_proj * n_text.n
    check_launches(f"judge {tag}", launches, want)
    if n_vis.n != 1 or not isinstance(text, str):
        fail(f"judge {tag}: {n_vis.n} vision forwards, output {type(text)}")

    ids, patches, grids = backend._prepare(request["images"], request["prompt"],
                                           request["system"])
    with torch.inference_mode():
        ids_t, pos_t, tl, patches_t, padded = gen.device_inputs(
            np.asarray([ids]), patches, tuple(grids), backend.prompt_bucket)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        ev[0].record()
        gen._prefill(ids_t, pos_t, tl, patches_t, tuple(grids), padded,
                     padded + 2 * DECODE_TOKENS + 2)
        ev[1].record()
        ev[1].synchronize()
        state = gen.start(np.asarray([ids]), patches, tuple(grids), 2 * DECODE_TOKENS + 2,
                          prompt_bucket=backend.prompt_bucket)
        per_step = {"decode_attention": (len(model.language_model.layers)
                                         if gen.kv_dtype == "bf16" else 0)}
        if kernel:
            per_step[kernel] = n_proj
        decode = decode_timings(gen, state, DECODE_TOKENS, tag, per_step)
        kernels = decode_step_kernels(lambda: gen.decode_step(state))
    if not torch.isfinite(state.logits.float()).all():
        fail(f"judge {tag}: non-finite logits")
    max_len = state.max_len
    tree = sum(t.numel() * t.element_size() for t in
               {t.data_ptr(): t for t in model.state_dict().values()}.values())
    bounds = judge_bounds(model, prec, padded, grids, max_len)
    out = {"prefill_ms": ev[0].elapsed_time(ev[1]),
           "decode_ms_per_token": decode["eager_ms"], "graph_ms_per_token": decode["graph_ms"],
           "decode": decode,
           "prefill_bound": bounds["prefill"], "decode_bound": bounds["decode"],
           "prompt_tokens": len(ids), "padded": padded, "wall_s": wall,
           "peak_gib": peak / 2**30, "tree_gib": tree / 2**30, "launches": launches,
           "forwards": n_text.n, "decode_kernels_per_token": kernels}
    if kernel and not (kernels[f"{kernel} calls"] >= n_proj
                       and kernels[f"{kernel} GEMV"] == kernels[f"{kernel} calls"]
                       and sum(kernels.values()) == 2 * kernels[f"{kernel} calls"]):
        fail(f"judge {tag}: a decode step's device kernels {kernels}: each {kernel} call "
             f"should be one GEMV launch")
    print(f"judge {tag}: {len(request['images'])} images, {len(ids)} prompt tokens "
          f"(bucket {padded}); generate {DECODE_TOKENS} tokens in {wall:.2f} s "
          f"(host clock, {n_text.n} decoder forwards); prefill "
          f"{out['prefill_ms']:.3f} ms (bound {bounds['prefill']['bound_ms']:.3f}, "
          f"{bounds['prefill']['bound_by']}), decode {out['decode_ms_per_token']:.3f} "
          f"ms/token eager, {out['graph_ms_per_token']:.3f} replayed from a CUDA graph "
          f"(bound {bounds['decode']['bound_ms']:.3f}, bytes) (CUDA events, "
          f"{DECODE_TOKENS} steps); peak memory {out['peak_gib']:.2f} GiB with the "
          f"three trees resident (this tree {out['tree_gib']:.2f} GiB); launches "
          f"{launches}; one more decode step's K5/K7 calls and device launches "
          f"{kernels} ({card})", flush=True)
    return out


# the reduced-depth check's generator options: the int8 KV cache, and a
# prefill in two chunks of half the prompt bucket
REDUCED_OPTIONS = ("", " kv_dtype=int8", " prefill_chunk=bucket/2")


def reduced_depth_check(cfg, state: dict, images: list, card: str) -> None:
    """The 8B's weights cut to 2 vision blocks (deepstack at 0) and 2 text
    layers at full width: last-position prefill logits on the card (the
    kernels) against the plain versions on the CPU, per precision, each
    also with the int8 KV cache and with a prefill in two chunks, under the
    same limits."""
    from emr2a_tpu_torch.judge.qwen_backend import QwenVLBackend
    from emr2a_tpu_torch.models.qwen3_vl import Qwen3VLGenerator

    small, sub = reduced_state(cfg, state)
    from emr2a_tpu_torch.tools.stub_tokenizer import WordTokenizer
    tok = WordTokenizer()
    prompt = "Is the predicted label consistent with the evidence? Answer in JSON."
    logits, alphas = {}, {}
    for prec in REDUCED_PRECISIONS:
        for dev in ("cuda", "cpu"):
            params = sub if dev == "cuda" else {k: v.cpu() for k, v in sub.items()}
            with awq_reports() as reports:
                be = QwenVLBackend(config=small, params=params, tokenizer=tok, precision=prec,
                                   prompt_bucket=16)
            if reports:
                alphas[dev] = ({l: e["alpha"] for l, e in reports[0]["report"].items()},
                               reports[0]["s"])
            ids, patches, grids = be._prepare(images, prompt, None)
            padded = -(-len(ids) // 16) * 16
            for opt in REDUCED_OPTIONS:
                kw = ({"kv_dtype": "int8"} if "kv_dtype" in opt else
                      {"prefill_chunk": padded // 2} if "prefill_chunk" in opt else {})
                gen = Qwen3VLGenerator(be.model, **kw)
                n_text = ForwardCount(be.model.language_model)
                if dev == "cuda":
                    torch.cuda.synchronize()
                    reset_counts()
                with torch.inference_mode():
                    inputs = gen.device_inputs(np.asarray([ids]), patches, tuple(grids), 16)
                    _, last, _ = gen._prefill(*inputs[:4], tuple(grids), inputs[4],
                                              inputs[4] + 1)
                n_text.remove()
                logits[prec + opt, dev] = last[0].float().cpu()
                if dev == "cuda":
                    torch.cuda.synchronize()
                    kernel = DECODER_KERNEL.get(prec)
                    want = {"frame_flash_attention": 2,
                            "decode_attention": k10_launches(be.model, n_text, gen.kv_dtype),
                            **({kernel: 14 * n_text.n} if kernel else {})}
                    check_launches(f"reduced-depth {prec}{opt}", read_counts(), want)
                    if n_text.n != (2 if "prefill_chunk" in kw else 1):
                        fail(f"reduced-depth {prec}{opt}: {n_text.n} decoder passes")
            del be

    def agreement(a, b, prec):
        cos = torch.nn.functional.cosine_similarity(a, b, dim=0).item()
        err = (a - b).abs().max().item()
        return cos, err, np.isfinite(err) and cos >= MIN_LOGIT_COSINE[prec] \
            and err <= MAX_LOGIT_ABS_ERR[prec]

    if alphas["cuda"][0] != alphas["cpu"][0]:
        fail(f"reduced-depth int4_awq: the card's AWQ picked alphas {alphas['cuda'][0]}, the "
             f"CPU's {alphas['cpu'][0]}")
    print(f"reduced-depth int4_awq: AWQ on the card ({alphas['cuda'][1]:.2f} s) and on the "
          f"CPU ({alphas['cpu'][1]:.2f} s, host clock) picked the same alphas "
          f"{alphas['cuda'][0]} ({card})", flush=True)
    for prec in REDUCED_PRECISIONS:
        a, b = logits[prec, "cuda"], logits[prec, "cpu"]
        cos, err, ok = agreement(a, b, prec)
        top_card, top_cpu = int(a.argmax()), int(b.argmax())
        gap = (b.topk(2).values[0] - b.topk(2).values[1]).item()
        control = CONTROL_OF[prec]
        control_ok = agreement(a, logits[control, "cpu"], prec)[2]
        print(f"reduced-depth {prec} (2 vision blocks, 2 text layers, full width; "
              f"{len(images)} images, {len(ids)} tokens): card vs CPU last-position "
              f"logits cosine {cos:.6f} (limit {MIN_LOGIT_COSINE[prec]}), max_abs_err "
              f"{err:.5f} (limit {MAX_LOGIT_ABS_ERR[prec]}; CPU logits within "
              f"+-{b.abs().max().item():.3f}), greedy token "
              f"{'equal' if top_card == top_cpu else f'{top_card} vs {top_cpu}'} "
              f"(CPU top-2 gap {gap:.5f}) ({card})", flush=True)
        for other in REDUCED_PRECISIONS:
            o_cos, o_err, _ = agreement(a, logits[other, "cpu"], prec)
            print(f"reduced-depth card {prec} vs CPU {other}: cosine {o_cos:.6f}, "
                  f"max_abs_err {o_err:.5f}", flush=True)
        if not ok or b[top_card] != b[top_cpu]:
            fail(f"reduced-depth {prec}: the card disagrees with the CPU's plain versions")
        if control_ok:
            fail(f"reduced-depth {prec}: the limits do not refuse the {control} control")
        for opt in REDUCED_OPTIONS[1:]:
            # the same limits and control; the greedy token within the
            # logits' limit of the CPU's (in int8 and int4 the CPU's top
            # logits tie in bf16 while the card's differ from them by about
            # 8 bf16 steps, so an exact greedy match is a coin toss there)
            a, b = logits[prec + opt, "cuda"], logits[prec + opt, "cpu"]
            cos, err, ok = agreement(a, b, prec)
            top_card, top_cpu = int(a.argmax()), int(b.argmax())
            gap = (b[top_cpu] - b[top_card]).item()
            control_ok = agreement(a, logits[CONTROL_OF[prec] + opt, "cpu"], prec)[2]
            print(f"reduced-depth {prec}{opt}: card vs CPU last-position logits cosine "
                  f"{cos:.6f} (limit {MIN_LOGIT_COSINE[prec]}), max_abs_err {err:.5f} "
                  f"(limit {MAX_LOGIT_ABS_ERR[prec]}), greedy token "
                  f"{'equal' if top_card == top_cpu else f'{top_card} vs {top_cpu}'} (the "
                  f"CPU scores the card's {gap:.5f} below its own); CPU against its one-shot "
                  f"bf16-cache logits: max_abs_err "
                  f"{(b - logits[prec, 'cpu']).abs().max().item():.5f}; the "
                  f"{CONTROL_OF[prec]}{opt} control "
                  f"{'not refused' if control_ok else 'refused'} ({card})", flush=True)
            if not ok or gap > MAX_LOGIT_ABS_ERR[prec]:
                fail(f"reduced-depth {prec}{opt}: the card disagrees with the CPU's plain "
                     f"versions")
            if control_ok:
                fail(f"reduced-depth {prec}{opt}: the limits do not refuse the "
                     f"{CONTROL_OF[prec]} control")


def model_axis_check(cfg, state: dict, card: str) -> None:
    """The model axis on one card: the judge cut to 2 + 2 layers at full
    width, greedy on a text prompt, with ``mesh=create_mesh((1, 1))`` (a
    one-card model axis: the plain path, its decode replayed from a CUDA
    graph) against ``mesh=None``, tokens equal; ``tp=2`` on one card raises
    the ``ValueError`` of a tp that does not divide the cards (four-card
    runs: ``tools/multichip_smoke.py --phases e``)."""
    from emr2a_tpu_torch.judge.qwen_backend import QwenVLBackend
    from emr2a_tpu_torch.models.qwen3_vl import Qwen3VLGenerator, Qwen3VLModel
    from emr2a_tpu_torch.parallel import create_mesh
    from emr2a_tpu_torch.tools.stub_tokenizer import WordTokenizer

    t0 = time.time()
    small, small_state = reduced_state(cfg, state)
    model = Qwen3VLModel.from_params(small, small_state)
    ids = np.arange(1000, 1000 + 40)[None]
    rows = {}
    for tag, mesh in (("mesh=None", None), ("mesh=(1, 1)", create_mesh((1, 1)))):
        gen = Qwen3VLGenerator(model, eos_token_id=-1, mesh=mesh)
        rows[tag] = gen.generate(ids, max_new_tokens=16, prompt_bucket=64)
        if not gen.replays:
            fail(f"model axis {tag}: decode does not replay a CUDA graph")
    if not np.array_equal(rows["mesh=None"], rows["mesh=(1, 1)"]):
        fail(f"model axis: mesh=(1, 1) tokens {rows['mesh=(1, 1)']} differ from mesh=None's "
             f"{rows['mesh=None']}")
    try:
        QwenVLBackend(config=small, params=small_state, tokenizer=WordTokenizer(), tp=2)
        fail("model axis: tp=2 on one card did not raise")
    except ValueError as e:
        refused = str(e)
    print(f"model axis on one card: 2 + 2 layers at full width, 16 greedy tokens with "
          f"mesh=create_mesh((1, 1)) equal mesh=None's (decode replayed from a CUDA graph); "
          f"tp=2 refused: {refused!r}; {time.time() - t0:.1f} s ({card})", flush=True)


def reduced_state(cfg, state: dict):
    """The 8B's weights cut to 2 vision blocks (deepstack at 0) and 2 text
    layers at full width, and their config."""
    from emr2a_tpu_torch.models.qwen3_vl import Qwen3VLConfig

    small = Qwen3VLConfig(
        vision=dataclasses.replace(cfg.vision, depth=2, deepstack_visual_indexes=(0,)),
        text=dataclasses.replace(cfg.text, num_layers=2))
    keep = re.compile(r"visual\.(blocks\.[01]\.|deepstack_mergers\.0\.|merger\.|patch_embed\.|"
                      r"pos_embed)|language_model\.(layers\.[01]\.|embed_tokens|final_ln|lm_head)")
    return small, {k: v for k, v in state.items() if keep.match(k)}


def qwen_encoder_phase(work: Path, manifest_path: Path, cfg, state: dict, model,
                       images: list, card: str) -> dict:
    """``Qwen3VLEncoder`` on the judge's random bf16 8B (its model passed in,
    no second copy): the tap embedding of two cohort slices and the masked
    mean of the cohort's clinical texts; the same weights cut to 2 vision
    blocks and 2 text layers on the card against the CPU; the CV driver on
    the Qwen text rows (card and CPU folds equal); step2 ``--encoder_type
    qwen3_vl_8b --model_path`` on a checkpoint directory written from the
    cut weights."""
    from emr2a_tpu_torch.analysis import run_cv_experiments as runner
    from emr2a_tpu_torch.data.manifest import load_manifest
    from emr2a_tpu_torch.encoders.qwen3_vl_encoder import Qwen3VLEncoder
    from emr2a_tpu_torch.tools.qwen_checkpoint import write_checkpoint
    from emr2a_tpu_torch.tools.stub_tokenizer import WordTokenizer

    tok = WordTokenizer()
    enc = Qwen3VLEncoder(model=model, tokenizer=tok)
    if enc.tap_indices != (24, 25, 26):
        fail(f"Qwen3VLEncoder taps {enc.tap_indices}, expected the last three of 27 blocks")
    arrays = [np.asarray(im) for im in images]
    manifest = load_manifest(manifest_path)
    pids = sorted(r["patient_id"] for r in manifest)
    texts = clinical_texts(len(pids))
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.time()
    img = enc.encode_batch_images(arrays)
    torch.cuda.synchronize()
    t_img = time.time() - t0
    t0 = time.time()
    txt = enc.encode_batch_texts(texts)
    torch.cuda.synchronize()
    t_txt = time.time() - t0
    launches = read_counts()
    check_launches("Qwen3VLEncoder", launches, {})
    img, txt = np.stack(img), np.stack(txt)
    if img.shape != (len(images), 1152) or txt.shape != (len(texts), 4096) \
            or not (np.isfinite(img).all() and np.isfinite(txt).all()):
        fail(f"Qwen3VLEncoder at 8B width: {img.shape} image, {txt.shape} text rows")
    print(f"Qwen3VLEncoder at Qwen3-VL-8B width (the judge's bf16 weights): {len(images)} "
          f"images {arrays[0].shape} -> taps {enc.tap_indices} mean-pooled, {img.shape} in "
          f"{t_img:.2f} s; {len(texts)} clinical texts -> masked mean of the final hidden "
          f"state (bucket 128), {txt.shape} in {t_txt:.2f} s; launches {launches} (one image "
          f"a forward: the flat vision attention, no K8; the bf16 decoder has no kernel) "
          f"({card})", flush=True)

    small, sub = reduced_state(cfg, state)
    reduced = {}
    for dev in ("cuda", "cpu"):
        e = Qwen3VLEncoder(config=small, params={k: v.to(dev) for k, v in sub.items()},
                           device=dev, tokenizer=tok)
        reduced[dev] = (np.stack(e.encode_batch_images(arrays)),
                        np.stack(e.encode_batch_texts(texts[:4])))
        del e
    for i, what in enumerate(("image taps", "text mean")):
        cos = hold(f"Qwen3VLEncoder reduced-depth {what}", list(reduced["cuda"][i]),
                   list(reduced["cpu"][i]), limit=MIN_LOGIT_COSINE["bf16"],
                   what="the CPU's plain versions")
        err = np.abs(reduced["cuda"][i] - reduced["cpu"][i]).max()
        print(f"Qwen3VLEncoder reduced-depth (2 vision blocks, 2 text layers, full width) "
              f"{what}: card vs CPU min cosine {cos:.6f} (limit {MIN_LOGIT_COSINE['bf16']}), "
              f"max_abs_err {err:.5f} ({card})", flush=True)

    # the CV driver with --text_encoder qwen3_vl_8b rows, card and CPU
    cv = work / "cv_qwen"
    cv.mkdir()
    bf16 = np.load(work / "bf16" / "embeddings.npz")
    np.savez_compressed(cv / "cohort.npz", patient_ids=np.asarray(pids),
                        image_matrix=np.stack([bf16[p].mean(0) for p in pids]),
                        text_matrix=txt.astype(np.float32))
    for dev in ("cuda", "cpu"):
        runner.main(["--manifest_path", str(manifest_path), "--output_dir", str(cv / dev),
                     "--experiment_id", "qwen", "--skip_encoding", "--embeddings_path",
                     str(cv / "cohort.npz"), "--text_encoder", "qwen3_vl_8b", "--fusion",
                     "concat", "--cv_folds", "3", "--device", dev])
    compare_cv("qwen3_vl_8b text", cv / "cuda" / "exp_qwen", cv / "cpu" / "exp_qwen")

    # step2's --model_path route on a checkpoint directory at the 8B's widths
    from emr2a_tpu_torch.pipelines.step2_embeddings import build_embeddings as step2
    t0 = time.time()
    ckpt = write_checkpoint(work / "qwen_ckpt", small, sub)
    size = (ckpt / "model.safetensors").stat().st_size / 2 ** 30
    two = work / "qwen_manifest.jsonl"
    two.write_text("".join(line + "\n" for line in
                           manifest_path.read_text(encoding="utf-8").splitlines()[:2]),
                   encoding="utf-8")
    t_write = time.time() - t0
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.time()
    step2.main(["--manifest_path", str(two), "--encoder_type", "qwen3_vl_8b", "--model_path",
                str(ckpt), "--device", "cuda", "--output_dir", str(work / "qwen_step2")])
    torch.cuda.synchronize()
    wall = time.time() - t0
    step2_launches = read_counts()
    check_launches("step2 qwen3_vl_8b", step2_launches, {})
    npz = np.load(work / "qwen_step2" / "embeddings.npz")
    first = json.loads(two.read_text(encoding="utf-8").splitlines()[0])
    if len(npz.files) != 2 or any(npz[p].shape != (40, 1152) or not np.isfinite(npz[p]).all()
                                  for p in npz.files):
        fail(f"step2 qwen3_vl_8b: {[(p, npz[p].shape) for p in npz.files]}")
    e = Qwen3VLEncoder(config=small, params=sub, tokenizer=tok)
    want = e.encode_images([Path(p) for p in first["slices"][:2]])
    cos = hold("step2 qwen3_vl_8b --model_path", list(npz[first["patient_id"]][:2]),
               list(want), limit=0.9999, what="the encoder on the same weights in memory")
    print(f"step2 --encoder_type qwen3_vl_8b --model_path (config.json + "
          f"{size:.2f} GiB model.safetensors at the 8B's widths, depth 2, written in "
          f"{t_write:.1f} s): 2 patients x 40 slices in {wall:.2f} s (load included); "
          f"launches {step2_launches}; min cosine {cos:.6f} against the encoder on the same "
          f"weights in memory ({card})", flush=True)
    del e, enc
    return {"Qwen3VLEncoder": launches}


def support_check(sample):
    """``sample`` (``qwen3_vl.sample_rows``) wrapped to count, on the
    device (so that a CUDA graph captures the count with the step and every
    replay runs it): the draws, those outside their step's filtered support
    (``filtered_log_probs`` of the very logits they were drawn from), and
    the least and most tokens a sampled row's support kept. Returns
    (wrapped, stats)."""
    from emr2a_tpu_torch.models import qwen3_vl

    stats = {k: torch.zeros((), dtype=torch.int64, device="cuda")
             for k in ("draws", "outside", "kept_max")}
    stats["kept_min"] = torch.full((), 10**9, dtype=torch.int64, device="cuda")

    def checked(logits, keys, temp, top_p):
        tok = sample(logits, keys, temp, top_p)
        lp = qwen3_vl.filtered_log_probs(logits, temp, top_p)
        kept = torch.isfinite(lp).sum(dim=-1)
        sampled = temp > 0
        stats["draws"] += tok.shape[0]
        stats["outside"] += (~torch.isfinite(lp.gather(1, tok[:, None]))).sum()
        torch.minimum(stats["kept_min"], torch.where(sampled, kept, 10**9).min(),
                       out=stats["kept_min"])
        torch.maximum(stats["kept_max"], torch.where(sampled, kept, 0).max(),
                      out=stats["kept_max"])
        return tok

    return checked, stats


def sampled_phase(backend, request: dict, card: str) -> dict:
    """A sampled generation on ``backend`` (the int4 judge), the audit
    request, temperature 0.7, top_p 0.9, seed SAMPLED_SEED, twice: every
    token inside its step's filtered support (``filtered_log_probs`` of the
    very logits it was drawn from) and the same tokens under the same seed.
    Returns the runs' launch counts."""
    from emr2a_tpu_torch.models import qwen3_vl

    gen = backend.generator
    ids, patches, grids = backend._prepare(request["images"], request["prompt"],
                                           request["system"])
    real = qwen3_vl.sample_rows
    checked, stats = support_check(real)
    gen.release()           # a kept graph of this shape would not run the check
    n_text = ForwardCount(backend.model.language_model)
    n_vis = ForwardCount(backend.model.visual)
    torch.cuda.synchronize()
    reset_counts()
    qwen3_vl.sample_rows = checked
    try:
        streams = [gen.generate(np.asarray([ids]), pixel_patches=patches,
                                grid_thw=tuple(grids), max_new_tokens=SAMPLED_TOKENS,
                                temperature=0.7, top_p=0.9, seed=SAMPLED_SEED,
                                prompt_bucket=backend.prompt_bucket) for _ in range(2)]
    finally:
        qwen3_vl.sample_rows = real
        gen.release()
    torch.cuda.synchronize()
    launches = read_counts()
    n_text.remove()
    n_vis.remove()
    check_launches("sampled", launches, {
        "frame_flash_attention": len(backend.model.visual.blocks) * n_vis.n,
        "linear_w4a8": 7 * len(backend.model.language_model.layers) * n_text.n,
        "decode_attention": k10_launches(backend.model, n_text, gen.kv_dtype)})
    draws, outside = int(stats["draws"]), int(stats["outside"])
    if draws != 2 * (SAMPLED_TOKENS + 1) or outside:
        fail(f"sampled: {outside} tokens outside their filtered support "
             f"({draws} draws)")
    if not np.array_equal(streams[0], streams[1]):
        fail("sampled: the same seed gave other tokens")
    print(f"sampled (int4 judge, temperature 0.7, top_p 0.9, seed {SAMPLED_SEED}): "
          f"{SAMPLED_TOKENS} tokens twice, equal; every one of {draws} draws inside "
          f"its filtered support ({int(stats['kept_min'])} to {int(stats['kept_max'])} "
          f"tokens kept of top-k "
          f"{qwen3_vl.SAMPLE_TOP_K}); tokens {streams[0][0].tolist()}; launches "
          f"{launches} ({card})", flush=True)
    return launches


class CappedBackend:
    """The judge with every generation capped at CAPPED_NEW_TOKENS new tokens
    (the review asks for 512, the VLM baseline for 2,048), recording each
    output: ``generate``, and ``generate_batch`` / ``generate_stream`` with
    the call's and every request's budget capped, so that no phase can
    launch an uncapped decode."""

    def __init__(self, backend):
        self.backend = backend
        self.texts = []

    def generate(self, images, prompt, system=None, max_new_tokens=1024, temperature=0.0):
        text = self.backend.generate(images, prompt, system=system,
                                     max_new_tokens=min(max_new_tokens, CAPPED_NEW_TOKENS),
                                     temperature=temperature)
        self.texts.append(text)
        return text

    def _capped(self, requests):
        return [{**r, "max_new_tokens": min(int(r["max_new_tokens"]), CAPPED_NEW_TOKENS)}
                if r.get("max_new_tokens") else r for r in requests]

    def generate_batch(self, requests, max_new_tokens=1024, **kw):
        texts = self.backend.generate_batch(
            self._capped(requests), max_new_tokens=min(max_new_tokens, CAPPED_NEW_TOKENS), **kw)
        self.texts.extend(texts)
        return texts

    def generate_stream(self, requests, max_new_tokens=1024, **kw):
        texts = self.backend.generate_stream(
            self._capped(requests), max_new_tokens=min(max_new_tokens, CAPPED_NEW_TOKENS), **kw)
        self.texts.extend(texts)
        return texts


def review_phase(work: Path, manifest_path: Path, backend, card: str) -> dict:
    """The CV runner's ``_run_vlm_review`` on the cohort's CV folds (the
    card's run) with ``backend`` (the int4 judge) passed in through
    ``VLMReviewModule(backend=...)``: REVIEW_SAMPLES reviews, each of which
    must have generated text, every decoder projection on K7. Returns the
    launch counts."""
    from emr2a_tpu_torch.analysis import run_cv_experiments as runner
    from emr2a_tpu_torch.data.manifest import load_manifest

    exp = work / "cv" / "cuda" / "exp_cohort"
    results = {"fold_results": [json.loads((f / "metrics.json").read_text(encoding="utf-8"))
                                for f in sorted(exp.glob("fold_*"))]}
    manifest = load_manifest(manifest_path)
    args = argparse.Namespace(vlm_model_path=None, device="cuda", vlm_prompt=None,
                              output_dir=str(work / "review"))
    capped = CappedBackend(backend)
    n_text = ForwardCount(backend.model.language_model)
    n_vis = ForwardCount(backend.model.visual)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.time()
    review = runner._run_vlm_review(args, "cohort", manifest,
                                    [r["patient_id"] for r in manifest], results,
                                    max_vlm_samples=REVIEW_SAMPLES, backend=capped)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = read_counts()
    n_text.remove()
    n_vis.remove()
    # one montage a request is one frame, which the vision tower (as JAX's)
    # attends on its flat path, not K8's frame batch
    check_launches("review", launches, {
        "linear_w4a8": 7 * len(backend.model.language_model.layers) * n_text.n,
        "decode_attention": k10_launches(backend.model, n_text,
                                         backend.generator.kv_dtype)})
    evidence = sorted(p.name for p in (work / "review" / "exp_cohort" / "vlm_review").iterdir())
    if (len(capped.texts) != REVIEW_SAMPLES or n_vis.n != REVIEW_SAMPLES
            or not all(isinstance(t, str) and t.strip() for t in capped.texts)
            or len(review["vlm_predictions"]) != REVIEW_SAMPLES
            or evidence != [f"evidence_{i}" for i in range(REVIEW_SAMPLES)]):
        fail(f"review: {len(capped.texts)} outputs {[len(t) for t in capped.texts]} chars, "
             f"{n_vis.n} vision forwards, evidence {evidence}")
    print(f"review (_run_vlm_review, int4 judge, max_new_tokens capped at "
          f"{CAPPED_NEW_TOKENS} of 512): {REVIEW_SAMPLES} reviews in {wall:.2f} s (host "
          f"clock), every one generated text ({[len(t.split()) for t in capped.texts]} "
          f"words); predictions {review['vlm_predictions']}, agreement_rate "
          f"{review['agreement_rate']}; {n_text.n} decoder forwards; launches {launches} "
          f"({card})", flush=True)
    return launches


# The serving phase's workload: the 12 audit requests of the cohort's CV
# folds with SERVING_BUDGETS' new-token budgets (heterogeneous, so that
# slots refill), the last two drawn at temperature 0.7, top_p 0.9 (seed 0,
# as QwenVLBackend.generate draws them)
SERVING_SAMPLED = (10, 11)
SERVING_MAX_NEW = 64
SERVING_SUPPORT_WAVE = slice(6, 12)   # the int4 wave whose draws are checked


def fold_requests(work: Path, manifest_path: Path) -> list:
    """The audit requests of the cohort's CV folds (the card's run), built
    as step4 builds them: each fold's test patients with their stored top
    neighbours, the majority label as the prediction."""
    from collections import Counter

    from emr2a_tpu_torch.data.manifest import load_manifest
    from emr2a_tpu_torch.judge.audit import VLMAuditModule
    from emr2a_tpu_torch.judge.backends import FakeVLMBackend
    from emr2a_tpu_torch.pipelines.step4_vlm_review.run import (
        load_retrieval_results_from_folds,
    )

    data = load_retrieval_results_from_folds(work / "cv" / "cuda" / "exp_cohort", 100)
    manifest = load_manifest(manifest_path)
    by_id = {r["patient_id"]: r for r in manifest}
    audit = VLMAuditModule(backend=FakeVLMBackend())
    requests = []
    for pid, labels, scores, pids in zip(data["test_patient_ids"], data["all_top_labels"],
                                         data["all_top_scores"],
                                         data["all_top_patient_ids"]):
        neighbors = [(n, label, float(score)) for label, score, n in zip(labels, scores, pids)]
        evidence = audit.construct_evidence_package(by_id[pid], neighbors, manifest, work)
        requests.append(audit._build_audit_request(
            evidence, Counter(labels).most_common(1)[0][0]))
    return requests


def generate_steps(backend, max_new: int) -> int:
    """The steps (and so the cache length) of the backend's generations
    of ``max_new`` tokens: whole decode chunks."""
    chunk = backend.decode_chunk
    return -(-max_new // chunk) * chunk if chunk else max_new


def b1_logits(backend, request: dict, indices: set) -> dict:
    """{k: the B = 1 greedy logits (f32, on the card) that chose token k of
    ``request``'s one-at-a-time stream (the prefill's for token 0)} for
    each k in ``indices``: the generation rebuilt on the generator (the
    same inputs, steps and cache length), stepped one replay at a time
    (bit for bit its eager steps, ``decode_timings``)."""
    from emr2a_tpu_torch.models.cuda_graph import StepGraph
    gen = backend.generator
    ids, patches, grids = backend._prepare(request["images"], request["prompt"],
                                           request["system"])
    out = {}
    with torch.inference_mode():
        state = gen.start(np.asarray([ids]), patches, tuple(grids),
                          generate_steps(backend, request["max_new_tokens"]),
                          prompt_bucket=backend.prompt_bucket)
        runner = StepGraph(gen.decode_step, state, state.token.device)
        for k in range(max(indices) + 1):
            runner.run(1 if k else 0)
            if k in indices:
                out[k] = state.logits[0].to(torch.float32, copy=True)
    return out


def top_two_gap(logits: torch.Tensor) -> float:
    top = torch.topk(logits, 2).values
    return float(top[0] - top[1])


def static_batch_logits(backend, requests: list, row_steps: dict) -> dict:
    """A second witness of ``generate_batch``: its static batch of
    ``requests`` rebuilt on the generator (the same inputs, steps and
    cache length), stepped one replay at a time; {row: the f32 logits that
    chose token ``row_steps[row]`` of that row}."""
    from emr2a_tpu_torch.models.cuda_graph import StepGraph
    gen = backend.generator
    out = {}
    with torch.inference_mode():
        state = gen.start(**backend.batch_inputs(requests),
                          steps=generate_steps(backend, SERVING_MAX_NEW),
                          prompt_bucket=backend.prompt_bucket)
        runner = StepGraph(gen.decode_step, state, state.token.device)
        for k in range(max(row_steps.values()) + 1):
            runner.run(1 if k else 0)
            for row, step in row_steps.items():
                if step == k:
                    out[row] = state.logits[row].to(torch.float32, copy=True)
    return out


def useful_tokens(rows: list, budgets: list, eos: int) -> int:
    """The tokens each row generated within its budget, through its first
    eos."""
    useful = 0
    for row, budget in zip(rows, budgets):
        stop = np.nonzero(row[:budget] == eos)[0]
        useful += int(stop[0]) + 1 if len(stop) else len(row[:budget])
    return useful


def serving_run(tag: str, backend, fn, requests: list, prec: str, draft=None) -> dict:
    """One serving call with the counts reset just before: its token rows
    (recorded from the backend's text decoding), host wall, launches, and
    the K7 / K8 launches checked against the replayed and prefilled
    forwards (a speculative ``draft`` model's too, where it is not the
    judge's own), and the graph captures it made (warm-up steps and
    captures, host ms)."""
    from emr2a_tpu_torch.models import cuda_graph
    rows, host = [], [0.0]
    decode_row, prepare = backend._decode_row, backend._prepare
    backend._decode_row = lambda row: rows.append(np.asarray(row)) or decode_row(row)

    def timed_prepare(*args):
        t = time.perf_counter()
        out = prepare(*args)
        host[0] += time.perf_counter() - t
        return out

    backend._prepare = timed_prepare
    n_text = ForwardCount(backend.model.language_model)
    n_vis = ForwardCount(backend.model.visual)
    other = draft is not None and draft is not backend.model
    if other:
        d_text, d_vis = ForwardCount(draft.language_model), ForwardCount(draft.visual)
    torch.cuda.synchronize()
    reset_counts()
    captures, capture_ms = cuda_graph.CAPTURES, cuda_graph.CAPTURE_MS
    t0 = time.perf_counter()
    try:
        texts = fn()
    finally:
        backend._decode_row, backend._prepare = decode_row, prepare
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    n_text.remove()
    n_vis.remove()
    kv = backend.generator.kv_dtype
    want = {"frame_flash_attention": len(backend.model.visual.blocks) * n_vis.n,
            "decode_attention": k10_launches(backend.model, n_text, kv)}
    if prec in ("int4", "int4_awq"):
        want["linear_w4a8"] = 7 * len(backend.model.language_model.layers) * n_text.n
    if other:
        d_text.remove()
        d_vis.remove()
        want["frame_flash_attention"] += len(draft.visual.blocks) * d_vis.n
        want["decode_attention"] += k10_launches(draft, d_text, kv)
        if "linear_w4a8" in want:
            want["linear_w4a8"] += 7 * len(draft.language_model.layers) * d_text.n
    check_launches(f"serving {prec} {tag}", launches, want)
    if len(rows) != len(requests) or not all(isinstance(t, str) for t in texts):
        fail(f"serving {prec} {tag}: {len(rows)} rows for {len(requests)} requests")
    useful = useful_tokens(rows, [r["max_new_tokens"] for r in requests],
                           backend.generator.eos_token_id)
    return {"rows": rows, "wall_s": wall, "prepare_s": host[0], "launches": launches,
            "captures": cuda_graph.CAPTURES - captures,
            "capture_ms": cuda_graph.CAPTURE_MS - capture_ms, "forwards": n_text.n,
            "vision_forwards": n_vis.n, "draft_forwards": d_text.n if other else None,
            "tokens": useful,
            "tokens_per_s": useful / wall, "cases_per_s": len(requests) / wall}


def support_wave(be, wave: list, batching, card: str) -> None:
    """One continuous wave at 8 slots on a fresh slot state with the
    batcher's draws counted on the device (``support_check``, captured with
    the chunk step): every draw, greedy or sampled, inside its filtered
    support, one per slot a step and one per insert."""
    real = batching.sample_rows
    checked, stats = support_check(real)
    for b in be._batchers.values():
        b.release()
    batching.sample_rows = checked
    try:
        be.generate_stream(wave, max_new_tokens=SERVING_MAX_NEW, n_slots=8)
        batcher = next(b for b in be._batchers.values() if b._runners)
        steps = batcher._runners[True].steps
    finally:
        batching.sample_rows = real
        for b in be._batchers.values():
            b.release()
    draws, outside = int(stats["draws"]), int(stats["outside"])
    want = batcher.n_slots * steps + len(wave)
    if draws != want or outside or int(stats["kept_max"]) < 2:
        fail(f"serving support: {outside} of {draws} draws outside their filtered support "
             f"(expected {want} draws; kept {int(stats['kept_min'])} to "
             f"{int(stats['kept_max'])})")
    print(f"serving int4 support wave ({len(wave)} requests, 2 sampled, 8 slots, fresh "
          f"state): every one of {draws} draws inside its filtered support ({steps} chunk "
          f"steps; a sampled row kept {int(stats['kept_min'])} to {int(stats['kept_max'])} "
          f"tokens of top-k 50) ({card})", flush=True)


def serving_phase(work: Path, manifest_path: Path, backends: dict, card: str) -> dict:
    """Batched and continuous serving of the cohort's fold requests on the
    int4 and the bf16 judge: one at a time (``generate``), static batches of
    8 (``generate_batch``) and continuous batching at 4 and 8 slots
    (``generate_stream``), each greedy request's stream against the one at
    a time (equal, or a near-tie at the first difference, within the
    precision's logit limit), the static batch's logits there read again
    from a second witness; continuous 8 served again on the kept slot state
    and graphs (every stream equal to the first wave's, the first replayed
    chunk step equal to the eager step bit for bit); on the int4 judge a
    wave with every draw checked inside its filtered support; step4 with
    ``--vlm_batch_size 4`` and with ``--serving continuous``; the JSONL
    service. Returns the launch counts by path, the rates and the peak
    memory."""
    from emr2a_tpu_torch.judge import serve
    from emr2a_tpu_torch.models import serving as batching
    from emr2a_tpu_torch.pipelines.step4_vlm_review.run import run_vlm_audit_pipeline

    requests = fold_requests(work, manifest_path)
    if len(requests) != len(SERVING_BUDGETS) or any(r is None for r in requests):
        fail(f"serving: {len(requests)} fold requests, expected {len(SERVING_BUDGETS)}")
    for i, r in enumerate(requests):
        r["max_new_tokens"] = SERVING_BUDGETS[i]
        if i in SERVING_SAMPLED:
            r.update(temperature=0.7, top_p=0.9, seed=0)
    greedy = [i for i in range(len(requests)) if i not in SERVING_SAMPLED]
    torch.cuda.reset_peak_memory_stats()
    counts, rates, one_at_a_time = {}, {}, {}
    for prec in ("int4", "bf16"):
        be, limit = backends[prec], MAX_LOGIT_ABS_ERR[prec]

        def continuous(n_slots):
            return lambda: be.generate_stream(requests, max_new_tokens=SERVING_MAX_NEW,
                                              n_slots=n_slots)

        def batcher8():
            return next(b for k, b in be._batchers.items()
                        if k[1:4] == (8, SERVING_MAX_NEW, False))

        modes = {
            "one at a time": lambda: [be.generate(
                r["images"], r["prompt"], system=r["system"],
                max_new_tokens=r["max_new_tokens"],
                temperature=r.get("temperature", 0.0), top_p=0.9) for r in requests],
            "generate_batch 8": lambda: [t for lo in range(0, len(requests), 8)
                                         for t in be.generate_batch(
                                             requests[lo:lo + 8],
                                             max_new_tokens=SERVING_MAX_NEW)],
            "continuous 4": continuous(4),
            "continuous 8": continuous(8),
            "continuous 8 again": continuous(8)}
        runs = {}
        for tag, fn in modes.items():
            runner = None
            if tag == "continuous 8 again":
                # the kept slot state and graph: the first replayed chunk
                # step held against the eager step on a copy of the state
                runner = batcher8()._runners[True]
                runner.verify = True
            runs[tag] = run = serving_run(tag, be, fn, requests, prec)
            if runner is not None:
                if runner.mismatches != [] or batcher8()._runners[True] is not runner \
                        or run["captures"]:
                    fail(f"serving {prec} {tag}: the replayed chunk step differs from the "
                         f"eager step in {runner.mismatches}, or the wave captured "
                         f"{run['captures']} graphs")
                for i, req in enumerate(requests):
                    n = req["max_new_tokens"]
                    if not np.array_equal(run["rows"][i][:n], runs["continuous 8"]["rows"][i][:n]):
                        fail(f"serving {prec} {tag}: request {i}'s stream differs from the "
                             f"first wave's")
        ref = one_at_a_time[prec] = runs["one at a time"]["rows"]
        batched = [tag for tag in runs if tag not in ("one at a time", "continuous 8 again")]
        first = {}      # (tag, request) -> its first token that differs from one at a time
        for tag in batched:
            for i in greedy:
                n = requests[i]["max_new_tokens"]
                diff = np.nonzero(runs[tag]["rows"][i][:n] != ref[i][:n])[0]
                if len(diff):
                    first[tag, i] = int(diff[0])
        need = {}
        for (_, i), k in first.items():
            need.setdefault(i, set()).add(k)
        b1 = {(i, k): lg for i, ks in need.items()
              for k, lg in b1_logits(be, requests[i], ks).items()}
        for (i, k), lg in b1.items():
            if int(torch.argmax(lg)) != int(ref[i][k]):
                fail(f"serving {prec}: request {i} rebuilt at B = 1 chose another token at "
                     f"{k} than one at a time did")
        for tag in batched:
            ties = [(i, k, round(top_two_gap(b1[i, k]), 4))
                    for (t, i), k in sorted(first.items()) if t == tag]
            for i, k, gap in ties:
                if gap > limit:
                    fail(f"serving {prec} {tag}: request {i} differs from one at a time at "
                         f"token {k}, where the B = 1 top-two gap is {gap:.4f} (limit {limit})")
            runs[tag].update(equal=len(greedy) - len(ties), compared=len(greedy),
                             near_ties=ties)
        # the static batch's logits at each first difference, read again on
        # the generator: they must choose the batch's token, and their
        # distance from the B = 1 logits is what a near-tie has to absorb
        drift = []
        for lo in range(0, len(requests), 8):
            rows = {i - lo: step for i, step, _ in runs["generate_batch 8"]["near_ties"]
                    if lo <= i < lo + 8}
            if not rows:
                continue
            witness = static_batch_logits(be, requests[lo:lo + 8], rows)
            for row, step in rows.items():
                i, w = lo + row, witness[row]
                if int(torch.argmax(w)) != int(runs["generate_batch 8"]["rows"][i][step]):
                    fail(f"serving {prec}: the static batch rebuilt chose another token for "
                         f"request {i} at token {step} than generate_batch did")
                drift.append((i, step, round(float((w - b1[i, step]).abs().max()), 4),
                              round(top_two_gap(w), 4)))
        sampled = [all(np.array_equal(runs[t]["rows"][i][:requests[i]["max_new_tokens"]],
                                      ref[i]) for t in ("continuous 4", "continuous 8"))
                   for i in SERVING_SAMPLED]
        for tag, run in runs.items():
            counts[f"serving {prec} {tag}"] = run["launches"]
            rates[f"{prec} {tag}"] = {k: run[k] for k in (
                "wall_s", "prepare_s", "tokens", "tokens_per_s", "cases_per_s", "forwards",
                "captures", "capture_ms")}
            extra = ("" if tag == "one at a time" else
                     "; every stream equal to the first wave's, its first replayed chunk step "
                     "equal to the eager step bit for bit" if tag == "continuous 8 again" else
                     f"; {run['equal']} of {run['compared']} greedy streams equal to one at "
                     f"a time, the others' first difference (request, token, B = 1 top-two "
                     f"gap) {run['near_ties']}, all within {limit}")
            print(f"serving {prec} {tag}: {len(requests)} cases in {run['wall_s']:.3f} s "
                  f"(host clock; {run['prepare_s']:.3f} s of it in the backend's host "
                  f"preprocessing, {run['capture_ms']:.1f} ms in {run['captures']} graph "
                  f"warm-ups and captures): {run['cases_per_s']:.3f} cases/s, "
                  f"{run['tokens']} tokens, {run['tokens_per_s']:.1f} tokens/s; "
                  f"{run['forwards']} decoder forwards{extra}; launches "
                  f"{nonzero(run['launches'])} ({card})", flush=True)
        print(f"serving {prec}: the static batch of 8 rebuilt on the generator chose the "
              f"batch's token at every first difference; (request, token, max |batch - "
              f"B = 1| logit, batch top-two gap) {drift} ({card})", flush=True)
        print(f"serving {prec}: the sampled requests' streams equal to one at a time's at "
              f"4 and 8 slots: {sampled} (their logits differ in the last bits, as the "
              f"greedy rows' do) ({card})", flush=True)
        if prec == "int4":
            support_wave(be, requests[SERVING_SUPPORT_WAVE], batching, card)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"serving: peak memory {peak:.2f} GiB with the three judges resident ({card})",
          flush=True)

    be = backends["int4"]
    exp_dir = work / "cv" / "cuda" / "exp_cohort"
    for tag, mode in (("static", dict(vlm_batch_size=4)),
                      ("continuous", dict(vlm_batch_size=4, serving="continuous"))):
        out = work / f"step4_{tag}"

        def step4():
            run_vlm_audit_pipeline(exp_dir, manifest_path, out, max_samples=STEP4_CASES,
                                   backend=be, vlm_max_new_tokens=STEP4_NEW_TOKENS, **mode)
            return [line for line in (out / "vlm_audit_details.jsonl").read_text().splitlines()]

        run = serving_run(f"step4 {tag}", be, step4,
                          [{"max_new_tokens": STEP4_NEW_TOKENS}] * STEP4_CASES, "int4")
        summary = json.loads((out / "vlm_audit_summary.json").read_text())
        details = (out / "vlm_audit_details.jsonl").read_text().splitlines()
        if len(details) != STEP4_CASES or len(summary["audit_results"]) != STEP4_CASES:
            fail(f"step4 {tag}: {len(details)} detail rows")
        counts[f"step4_int4 {tag}"] = run["launches"]
        print(f"step4 --vlm_batch_size 4{' --serving continuous' if 'serving' in mode else ''}"
              f" (int4 judge): {STEP4_CASES} cases in {run['wall_s']:.2f} s (host clock); "
              f"{run['forwards']} decoder forwards, {run['vision_forwards']} vision forwards; "
              f"decisions {summary['audit_summary']}; launches {nonzero(run['launches'])} "
              f"({card})",
              flush=True)

    images = requests[0]["images"][:2]
    paths = [work / f"serve_{i}.png" for i in range(2)]
    for img, path in zip(images, paths):
        img.save(path)
    inp, res = work / "serve_in.jsonl", work / "serve_out.jsonl"
    inp.write_text("\n".join([
        json.dumps({"id": "a", "prompt": "Is the label right?",
                    "images": [str(p) for p in paths]}),
        "not json {",
        json.dumps({"id": "b", "prompt": "Describe the slice.", "images": [str(paths[0])],
                    "temperature": 0.7, "seed": 5, "max_new_tokens": 8}),
        json.dumps({"id": "c", "prompt": "x", "images": [str(work / "missing.png")]})]) + "\n")
    t0 = time.time()
    serve.main(["--model_path", "int4 judge", "--input", str(inp), "--output", str(res),
                "--n_slots", "4", "--max_new_tokens", "16"], backend=be)
    lines = {r["id"]: r for r in map(json.loads, res.read_text().splitlines())}
    if not (set(lines) == {"a", "b", "c", "line_2"} and lines["a"]["ok"] and lines["b"]["ok"]
            and all(isinstance(lines[k]["output"], str) for k in "ab")
            and not lines["c"]["ok"] and "not found" in lines["c"]["error"]
            and "invalid JSON" in lines["line_2"]["error"]):
        fail(f"serve CLI: responses {lines}")
    print(f"serve CLI (int4 judge, 4 slots): {len(lines)} response lines in "
          f"{time.time() - t0:.2f} s: a and b served, c image not found, line 2 invalid "
          f"JSON ({card})", flush=True)
    return {"counts": counts, "rates": rates, "peak_gib": peak, "requests": requests,
            "one_at_a_time": one_at_a_time}


# The speculative and AWQ phase (after serving): k proposals a cycle, the
# new tokens of the B = 1 runs, the shallow draft's depth and seed, and the
# cycles timed from a CUDA graph
SPEC_K, SPEC_NEW_TOKENS, SHALLOW_LAYERS, SHALLOW_SEED = 4, 32, 4, 1
SPEC_CYCLES_TIMED = 8
# AWQ's gate against RTN (``tools/awq_depth.py``): JAX's outlier-embedding
# fixture on the judge's first AWQ_GATE_LAYERS layers at full width, the
# logits cosine to bf16 averaged over 512 seeded ids. int4_awq must gain
# AWQ_GATE_MARGIN over int4 there, about a third of the gain measured at 2
# to 8 layers (PERF.md, section 5). At 36 layers, with the fixture, the two
# sit within 0.004 of each other, inside the bf16 fold's own 0.003, so the
# full depth's cosines are printed only.
AWQ_GATE_LAYERS, AWQ_GATE_MARGIN = 4, 0.005


@contextlib.contextmanager
def awq_reports():
    """``models/awq.awq_quantize_qwen_text_params`` recorded while the
    context is open: each call's report and host seconds (the card's work
    synchronised)."""
    from emr2a_tpu_torch.models import awq
    real, reports = awq.awq_quantize_qwen_text_params, []

    def recorded(model, *args, **kw):
        t0 = time.perf_counter()
        out = real(model, *args, **kw)
        if model.language_model.final_ln.weight.is_cuda:
            torch.cuda.synchronize()
        reports.append({"report": out[1], "s": time.perf_counter() - t0})
        return out

    awq.awq_quantize_qwen_text_params = recorded
    try:
        yield reports
    finally:
        awq.awq_quantize_qwen_text_params = real


def awq_depth_gate(cfg, state: dict, tok, card: str) -> dict:
    """int4_awq against int4 on the outlier fixture at AWQ_GATE_LAYERS
    layers (``tools/awq_depth.awq_cosines``): fails unless int4_awq's
    logits cosine to bf16, averaged over positions, beats int4's by
    AWQ_GATE_MARGIN."""
    from emr2a_tpu_torch.tools import awq_depth
    cos = awq_depth.awq_cosines(cfg, awq_depth.outlier_state(state), AWQ_GATE_LAYERS, tok)
    if not cos["int4_awq"]["mean"] >= cos["int4"]["mean"] + AWQ_GATE_MARGIN:
        fail(f"int4_awq (outlier fixture, {AWQ_GATE_LAYERS} layers): mean logits cosine to "
             f"bf16 {cos['int4_awq']['mean']:.6f}, not {AWQ_GATE_MARGIN} above int4's "
             f"{cos['int4']['mean']:.6f}")
    print(f"int4_awq gate (JAX's outlier-embedding fixture on the judge's first "
          f"{AWQ_GATE_LAYERS} layers at full width; alpha > 0 at {len(cos['alpha_pos'])} of "
          f"{4 * AWQ_GATE_LAYERS} sites): logits cosine to bf16 over "
          f"{awq_depth.EVAL_TOKENS} seeded ids, mean int4 {cos['int4']['mean']:.6f}, int4_awq "
          f"{cos['int4_awq']['mean']:.6f} (at least int4's + {AWQ_GATE_MARGIN}); last "
          f"position int4 {cos['int4']['last']:.6f}, int4_awq {cos['int4_awq']['last']:.6f} "
          f"({card})", flush=True)
    return {k: cos[k] for k in ("int4", "int4_awq", "alpha_pos")}


def prefill_logits(backend, request: dict) -> torch.Tensor:
    """The last-position prefill logits (f32) of ``request`` on ``backend``."""
    gen = backend.generator
    ids, patches, grids = backend._prepare(request["images"], request["prompt"],
                                           request["system"])
    with torch.inference_mode():
        inputs = gen.device_inputs(np.asarray([ids]), patches, tuple(grids),
                                   backend.prompt_bucket)
        _, last, _ = gen._prefill(*inputs[:4], tuple(grids), inputs[4], inputs[4] + 1)
    return last[0].float()


def accept_support_check(accept):
    """``qwen3_vl.spec_accept`` wrapped to count on the device (captured
    with the cycle): the tokens each call emits (the accepted drafts and the
    correction or bonus) and those outside the target's filtered support."""
    stats = {k: torch.zeros((), dtype=torch.int64, device="cuda")
             for k in ("emitted", "outside")}

    def checked(drafts, q_lp, p_lp, keys):
        emitted, n_acc = accept(drafts, q_lp, p_lp, keys)
        valid = torch.arange(emitted.shape[1], device=emitted.device)[None, :] <= n_acc[:, None]
        finite = torch.isfinite(p_lp.gather(2, emitted[:, :, None])[..., 0])
        stats["emitted"] += valid.sum()
        stats["outside"] += (valid & ~finite).sum()
        return emitted, n_acc

    return checked, stats


def near_ties(tag: str, base, requests: list, rows: list, ref: list, indices, limit: float):
    """Each greedy request's stream against one at a time: equal, or its
    first difference a near-tie of the B = 1 logits rebuilt on ``base``'s
    generator (their argmax the one-at-a-time token, their top-two gap
    within ``limit``). Returns the (request, token, gap) of the ties."""
    first = {}
    for i in indices:
        n = requests[i]["max_new_tokens"]
        diff = np.nonzero(np.asarray(rows[i])[:n] != np.asarray(ref[i])[:n])[0]
        if len(diff):
            first[i] = int(diff[0])
    ties = []
    for i, k in sorted(first.items()):
        lg = b1_logits(base, requests[i], {k})[k]
        gap = round(top_two_gap(lg), 4)
        if int(torch.argmax(lg)) != int(ref[i][k]) or gap > limit:
            fail(f"{tag}: request {i} differs from one at a time at token {k}, where the "
                 f"B = 1 logits choose {int(torch.argmax(lg))} with top-two gap {gap:.4f} "
                 f"(limit {limit})")
        ties.append((i, k, gap))
    return ties


def spec_cycle_ms(spec, backend, request: dict) -> float:
    """The device ms of one speculative cycle on ``request``: SPEC_CYCLES_TIMED
    cycles replayed from a CUDA graph after the warm-up, the capture and one
    replay, between two CUDA events (a finished row's cycle runs the same
    kernels)."""
    from emr2a_tpu_torch.models.cuda_graph import StepGraph
    ids, patches, grids = backend._prepare(request["images"], request["prompt"],
                                           request["system"])
    with torch.inference_mode():
        state = spec.start(np.asarray([ids]), patches, tuple(grids),
                           max_new_tokens=SPEC_NEW_TOKENS, prompt_bucket=backend.prompt_bucket)
        runner = StepGraph(spec.cycle, state, "cuda")
        runner.run(2)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        ev[0].record()
        runner.run(SPEC_CYCLES_TIMED)
        ev[1].record()
        ev[1].synchronize()
    return ev[0].elapsed_time(ev[1]) / SPEC_CYCLES_TIMED


def spec_awq_phase(work: Path, manifest_path: Path, cfg, state: dict, backends: dict,
                   request: dict, runs: dict, serving: dict, card: str) -> dict:
    """AWQ and speculative decoding on the judges the serving phase holds.

    AWQ: an int4_awq judge built from the bf16 weights on the card
    (``QwenVLBackend(precision="int4_awq")``: 4 x 256 calibration ids of the
    judge's prompts through the stub tokenizer, the search, the fold and
    K7's quantization); every site's AWQ error at most its RTN error (a
    consistency check of the search's report: RTN, alpha 0, is one of its
    candidates); the judge request's last-position prefill logits, cosine
    to bf16 for int4 and int4_awq, printed, on the plain weights and with
    JAX's outlier-embedding fixture (on the plain random weights AWQ's
    diagonal objective takes alpha > 0 at a few sites where it does not
    pay); the gate against RTN, ``awq_depth_gate``; step4 on 4 cases with
    the int4_awq judge.

    Speculative at B = 1 on the int4 judge, k = SPEC_K, the judge request:
    the self-draft (the judge's own model) and a seeded shallow draft (the
    8B's widths, SHALLOW_LAYERS decoder layers, quantized in int4, built
    through ``QwenVLBackend(draft_config=..., draft_params=...)``). Each
    greedy stream against the plain generator's (equal, or a near-tie
    within int4's 0.75); the kept cycle graph's first replayed cycle of a
    second generation against the eager cycle, bit for bit; K7 and K8
    launches against the forwards of both models; acceptance, tokens a
    cycle, the cycle's ms and ms per token beside plain graph decode's. A
    sampled generation (temperature 0.7, top_p 0.9, seed SAMPLED_SEED) on
    the shallow draft, twice: the same tokens, every emitted token inside
    the target's filtered support and every draw inside its own (counted
    on the card, in the graph).

    Speculative continuous serving: the serving phase's 12 fold requests at
    8 slots with the self-draft, greedy streams against one at a time,
    rates beside plain continuous 8's; step4 on 4 cases through the
    speculative backend. Returns the launch counts by path."""
    from emr2a_tpu_torch.judge.qwen_backend import QwenVLBackend
    from emr2a_tpu_torch.models import qwen3_vl, speculative
    from emr2a_tpu_torch.models.speculative import SpeculativeGenerator
    from emr2a_tpu_torch.pipelines.step4_vlm_review.run import run_vlm_audit_pipeline
    from emr2a_tpu_torch.tools import awq_depth
    from emr2a_tpu_torch.tools.stub_tokenizer import WordTokenizer

    tok = WordTokenizer()
    counts = {}
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.time()

    # -- AWQ ------------------------------------------------------------------
    with awq_reports() as reports:
        t0 = time.time()
        awq_be = QwenVLBackend(config=cfg, params=state, tokenizer=tok, precision="int4_awq")
        torch.cuda.synchronize()
        build_s = time.time() - t0
    report, awq_s = reports[0]["report"], reports[0]["s"]
    sites = [(layer, site, e["err"][site]) for layer, e in report.items()
             for site in ("qkv", "o", "gu", "down")]
    worse = [(l, s_, e) for l, s_, e in sites if e["awq"] > e["rtn"]]
    taken = sum(1 for e in report.values() for a in e["alpha"].values() if a > 0)
    gain = [1 - e["awq"] / e["rtn"] for _, _, e in sites if e["rtn"] > 0]
    if worse or len(sites) != 4 * cfg.text.num_layers:      # a consistency check
        fail(f"int4_awq: {len(worse)} sites whose AWQ error exceeds RTN's: {worse[:4]}")
    def cosines(judges: dict) -> dict:
        ref = prefill_logits(judges["bf16"], request)
        return {prec: torch.nn.functional.cosine_similarity(
            prefill_logits(judges[prec], request), ref, dim=0).item()
            for prec in ("int4", "int4_awq")}

    cos = cosines({"bf16": backends["bf16"], "int4": backends["int4"], "int4_awq": awq_be})
    loud = awq_depth.outlier_state(state)
    with awq_reports() as loud_reports:
        loud_judges = {prec: QwenVLBackend(config=cfg, params=loud, tokenizer=tok,
                                           precision=prec)
                       for prec in ("bf16", "int4", "int4_awq")}
    loud_cos = cosines(loud_judges)
    loud_taken = sum(1 for e in loud_reports[0]["report"].values()
                     for a in e["alpha"].values() if a > 0)
    del loud_judges, loud
    torch.cuda.empty_cache()
    print(f"int4_awq judge: AWQ (calibration on 4 x 256 ids, search over 5 alphas at "
          f"{len(sites)} sites, fold, K7 quantization) in {awq_s:.2f} s on the card, the "
          f"backend in {build_s:.2f} s (host clock); alpha > 0 at {taken} of {len(sites)} "
          f"sites; every site's AWQ error <= its RTN error (relative gain median "
          f"{np.median(gain):.4f}, max {max(gain):.4f}); the judge request's last-position "
          f"prefill logits cosine to bf16 at full depth (printed, not gated): int4 "
          f"{cos['int4']:.6f}, int4_awq {cos['int4_awq']:.6f}; with JAX's outlier-embedding "
          f"fixture ({awq_depth.OUTLIER_CHANNELS} channels x {awq_depth.OUTLIER_FACTOR:g}; "
          f"alpha > 0 at {loud_taken} sites): int4 {loud_cos['int4']:.6f}, int4_awq "
          f"{loud_cos['int4_awq']:.6f} ({card})", flush=True)
    gate = awq_depth_gate(cfg, state, tok, card)
    exp_dir = work / "cv" / "cuda" / "exp_cohort"

    def step4(tag: str, be, draft=None, prec="int4"):
        out = work / f"step4_{tag}"

        def go():
            run_vlm_audit_pipeline(exp_dir, manifest_path, out, max_samples=STEP4_CASES,
                                   backend=be, vlm_max_new_tokens=STEP4_NEW_TOKENS)
            return (out / "vlm_audit_details.jsonl").read_text().splitlines()

        run = serving_run(f"step4 {tag}", be, go,
                          [{"max_new_tokens": STEP4_NEW_TOKENS}] * STEP4_CASES, prec, draft)
        summary = json.loads((out / "vlm_audit_summary.json").read_text())
        details = (out / "vlm_audit_details.jsonl").read_text().splitlines()
        if len(details) != STEP4_CASES or len(summary["audit_results"]) != STEP4_CASES \
                or run["vision_forwards"] < STEP4_CASES:
            fail(f"step4 {tag}: {len(details)} detail rows, {run['vision_forwards']} vision "
                 f"forwards")
        counts[f"step4 {tag}"] = run["launches"]
        print(f"step4 ({tag}): {STEP4_CASES} cases, {STEP4_NEW_TOKENS} new tokens each, in "
              f"{run['wall_s']:.2f} s (host clock); {run['forwards']} judge decoder forwards, "
              f"{run['vision_forwards']} judge vision forwards; decisions "
              f"{summary['audit_summary']}; launches {nonzero(run['launches'])}; both "
              f"artifacts written ({card})", flush=True)

    step4("int4_awq", awq_be, prec="int4_awq")
    del awq_be
    torch.cuda.empty_cache()

    # -- speculative at B = 1 -------------------------------------------------
    base = backends["int4"]
    eos, kv = base.generator.eos_token_id, base.generator.kv_dtype
    self_be = copy.copy(base)
    self_be._batchers = {}
    self_be.spec_generator = SpeculativeGenerator(base.model, base.model, spec_k=SPEC_K,
                                                  eos_token_id=eos, kv_dtype=kv)
    shallow_cfg = dataclasses.replace(cfg, text=dataclasses.replace(
        cfg.text, num_layers=SHALLOW_LAYERS))
    shallow = qwen3_vl.random_state(shallow_cfg, seed=SHALLOW_SEED, device="cuda")
    t0 = time.time()
    shallow_be = QwenVLBackend(config=cfg, params=state, tokenizer=tok, precision="int4",
                               draft_config=shallow_cfg, draft_params=shallow,
                               spec_k=SPEC_K)
    torch.cuda.synchronize()
    n_shallow = sum(t.numel() for t in shallow.values()) / 1e9
    del shallow
    print(f"shallow draft: the 8B's widths cut to {SHALLOW_LAYERS} decoder layers, random "
          f"weights (seed {SHALLOW_SEED}), {n_shallow:.3f} B parameters; the speculative int4 "
          f"backend built in {time.time() - t0:.1f} s ({card})", flush=True)
    ids, patches, grids = base._prepare(request["images"], request["prompt"], request["system"])
    req = dict(request, max_new_tokens=SPEC_NEW_TOKENS)
    with torch.inference_mode():
        plain = base.generator.generate(np.asarray([ids]), patches, tuple(grids),
                                        max_new_tokens=SPEC_NEW_TOKENS,
                                        prompt_bucket=base.prompt_bucket,
                                        chunk=base.decode_chunk)[0]
    plain_ms = runs["int4"]["graph_ms_per_token"]
    spec_rates = {}
    for tag, be in (("self-draft", self_be), ("shallow draft", shallow_be)):
        spec = be.spec_generator
        fn = lambda: [be.generate(request["images"], request["prompt"], system=request["system"],
                                  max_new_tokens=SPEC_NEW_TOKENS)]
        first = serving_run(f"speculative {tag}", be, fn, [req], "int4", spec.dm)
        ties = near_ties(f"speculative {tag}", base, [req], first["rows"], [plain], [0],
                         MAX_LOGIT_ABS_ERR["int4"])
        key = next(iter(spec._graphs))
        runner = spec._graphs[key]
        s = runner.state
        # the tokens the cycles emitted within the budget (the last cycle may
        # overshoot it; the first token is the prefill's)
        cycles, accepted = int(s.cycles), int(s.accepted)
        emitted = min(int(s.n_emitted), SPEC_NEW_TOKENS) - 1
        runner.verify = True
        again = serving_run(f"speculative {tag} again", be, fn, [req], "int4", spec.dm)
        if runner.mismatches != [] or spec._graphs.get(key) is not runner or again["captures"] \
                or not np.array_equal(again["rows"][0], first["rows"][0]):
            fail(f"speculative {tag}: the replayed cycle differs from the eager cycle in "
                 f"{runner.mismatches}, or the second generation captured {again['captures']} "
                 f"graphs or gave other tokens")
        counts[f"speculative {tag}"] = first["launches"]
        cycle_ms = spec_cycle_ms(spec, be, request)
        per_token = cycle_ms * cycles / emitted
        spec_rates[tag] = {"cycle_ms": cycle_ms, "cycles": cycles, "accepted": accepted,
                           "emitted": emitted, "emitted_past_budget": int(s.n_emitted) - 1 - emitted,
                           "acceptance": accepted / (cycles * SPEC_K),
                           "tokens_per_cycle": emitted / cycles, "ms_per_token": per_token,
                           "plain_graph_ms_per_token": plain_ms, "near_ties": ties,
                           "wall_s": first["wall_s"]}
        print(f"speculative {tag} (int4 judge, k = {SPEC_K}, the judge request, "
              f"{SPEC_NEW_TOKENS} new tokens): {cycles} cycles, {accepted} of "
              f"{cycles * SPEC_K} drafts accepted (acceptance "
              f"{spec_rates[tag]['acceptance']:.3f}, the last cycle's drafts past the budget "
              f"included), {emitted} tokens within the budget after the prefill's "
              f"({spec_rates[tag]['emitted_past_budget']} past it), {emitted / cycles:.3f} of "
              f"them a cycle; a cycle {cycle_ms:.3f} ms replayed from its CUDA graph (CUDA "
              f"events, {SPEC_CYCLES_TIMED} cycles), {per_token:.3f} ms per token within the "
              f"budget against "
              f"plain graph decode's {plain_ms:.3f}; generate in {first['wall_s']:.2f} s (host "
              f"clock, prefills and capture included); the stream "
              f"{'equal to the plain generator' if not ties else f'a near-tie {ties}'}; the "
              f"second generation's first replayed cycle equal to the eager cycle bit for "
              f"bit; {first['forwards']} judge decoder forwards, "
              f"{first['draft_forwards'] if first['draft_forwards'] is not None else first['forwards']} "
              f"counted for the draft; launches {nonzero(first['launches'])} ({card})",
              flush=True)

    spec = shallow_be.spec_generator
    real_accept, real_sample = speculative.spec_accept, speculative.sample_rows
    checked_acc, acc_stats = accept_support_check(real_accept)
    checked_draw, draw_stats = support_check(real_sample)
    spec.release()              # a kept graph would not run the checks
    n_text, n_draft = ForwardCount(spec.tm.language_model), ForwardCount(spec.dm.language_model)
    n_vis, n_dvis = ForwardCount(spec.tm.visual), ForwardCount(spec.dm.visual)
    speculative.spec_accept, speculative.sample_rows = checked_acc, checked_draw
    try:
        torch.cuda.synchronize()
        reset_counts()
        streams = [spec.generate(np.asarray([ids]), patches, tuple(grids),
                                 max_new_tokens=SPEC_NEW_TOKENS, prompt_bucket=base.prompt_bucket,
                                 temperature=0.7, top_p=0.9, seed=SAMPLED_SEED)
                   for _ in range(2)]
        torch.cuda.synchronize()
        launches = read_counts()
    finally:
        speculative.spec_accept, speculative.sample_rows = real_accept, real_sample
        spec.release()
        for c in (n_text, n_draft, n_vis, n_dvis):
            c.remove()
    check_launches("speculative sampled", launches, {
        "frame_flash_attention": len(spec.tm.visual.blocks) * n_vis.n
        + len(spec.dm.visual.blocks) * n_dvis.n,
        "linear_w4a8": 7 * (len(spec.tm.language_model.layers) * n_text.n
                            + len(spec.dm.language_model.layers) * n_draft.n),
        "decode_attention": k10_launches(spec.tm, n_text, spec.kv_dtype)
        + k10_launches(spec.dm, n_draft, spec.kv_dtype)})
    counts["speculative sampled"] = launches
    emitted, outside = int(acc_stats["emitted"]), int(acc_stats["outside"])
    draws, draws_out = int(draw_stats["draws"]), int(draw_stats["outside"])
    if outside or draws_out or not emitted or not np.array_equal(streams[0], streams[1]):
        fail(f"speculative sampled: {outside} of {emitted} emitted tokens outside the target's "
             f"filtered support, {draws_out} of {draws} draws outside their own, or the same "
             f"seed gave other tokens")
    print(f"speculative sampled (shallow draft, temperature 0.7, top_p 0.9, seed "
          f"{SAMPLED_SEED}, {SPEC_NEW_TOKENS} tokens) twice: equal streams; every one of "
          f"{emitted} tokens the acceptance emitted inside the target's filtered support and "
          f"every one of {draws} draws (the first token's and the draft's) inside its own "
          f"(counted on the card, in the cycle's graph); tokens {streams[0][0].tolist()}; "
          f"launches {nonzero(launches)} ({card})", flush=True)
    shallow_be.spec_generator.release()
    del shallow_be, spec
    torch.cuda.empty_cache()

    # -- speculative continuous serving -----------------------------------------
    requests = serving["requests"]
    ref = serving["one_at_a_time"]["int4"]
    run = serving_run("speculative continuous 8", self_be,
                      lambda: self_be.generate_stream(requests, max_new_tokens=SERVING_MAX_NEW,
                                                      n_slots=8),
                      requests, "int4", self_be.spec_generator.dm)
    greedy = [i for i in range(len(requests)) if i not in SERVING_SAMPLED]
    ties = near_ties("speculative continuous 8", base, requests, run["rows"], ref, greedy,
                     MAX_LOGIT_ABS_ERR["int4"])
    batcher = next(iter(self_be._batchers.values()))
    cycles = batcher._runners["spec", True].steps
    plain8 = serving["rates"]["int4 continuous 8"]
    counts["speculative continuous 8"] = run["launches"]
    spec_rates["continuous 8"] = {k: run[k] for k in ("wall_s", "tokens", "tokens_per_s",
                                                      "cases_per_s", "forwards", "captures")}
    spec_rates["continuous 8"].update(near_ties=ties, chunk_cycles=cycles,
                                      plain_tokens_per_s=plain8["tokens_per_s"],
                                      plain_cases_per_s=plain8["cases_per_s"],
                                      k7_t40_ms=K7_AT.get(40))
    print(f"speculative continuous 8 (int4 judge, self-draft, k = {SPEC_K}, the 12 fold "
          f"requests, 2 sampled): {run['cases_per_s']:.3f} cases/s, {run['tokens_per_s']:.1f} "
          f"tokens/s ({run['tokens']} tokens in {run['wall_s']:.3f} s, host clock) against "
          f"plain continuous 8's {plain8['cases_per_s']:.3f} cases/s, "
          f"{plain8['tokens_per_s']:.1f} tokens/s; {cycles} cycles, {run['forwards']} judge "
          f"decoder forwards (draft steps included); {len(greedy) - len(ties)} of {len(greedy)} "
          f"greedy streams equal to one at a time, near-ties {ties}; the verify's K7 at T = 40 "
          f"{K7_AT.get(40, float('nan')):.4f} ms a layer (chained, phase 11) against "
          f"{K7_AT.get(5, float('nan')):.4f} at T = 5; launches {nonzero(run['launches'])} "
          f"({card})", flush=True)
    step4("speculative", self_be, draft=self_be.spec_generator.dm)
    for b in self_be._batchers.values():
        b.release()
    self_be.spec_generator.release()
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"speculative and AWQ phase in {time.time() - t_phase:.1f} s (host clock); peak "
          f"memory {peak:.2f} GiB ({card})", flush=True)
    return {"counts": counts, "rates": spec_rates, "awq": {
        "seconds": awq_s, "build_s": build_s, "alpha_positive": taken, "sites": len(sites),
        "cosine": cos, "outlier_cosine": loud_cos, "gate": gate}, "peak_gib": peak}


# -- the paper's baselines, the trainer and the bring-up CLI -----------------

VLM_DIRECT_PATIENTS = 4
VLM_DIRECT_TEMPS = ("0.0", "0.7")
VLM_RESULTS_KEYS = {"config", "folds"}
VLM_CONFIG_KEYS = {"n_samples_per_fold", "random_seed", "temperatures", "protocol", "serving",
                   "prompt_template", "system_message"}
VLM_FOLD_KEYS = {"sampled_patient_ids", "predictions", "metrics", "agreement"}
VLM_SUMMARY_KEYS = {"total_samples", "temperatures", "average_metrics"}


def vlm_direct_run(tag: str, be, argv: list, out_dir: Path, fold_key: str,
                   n_patients: int, card: str) -> dict:
    """One ``run_vlm_direct_judging.main`` with the int4 judge passed in,
    capped at CAPPED_NEW_TOKENS, the counts reset just before and read
    just after: every request generated text, K8 on every vision block and
    K7 on every decoder projection of its forwards (prefills and replayed
    steps), no other kernel; both artifacts with JAX's keys. Returns its
    token rows (in request order), wall time, launches and rates."""
    from emr2a_tpu_torch.baselines.vlm_direct import run_vlm_direct_judging as vlm

    capped = CappedBackend(be)
    rows, decode_row = [], be._decode_row
    be._decode_row = lambda row: rows.append(np.asarray(row)) or decode_row(row)
    n_text = ForwardCount(be.model.language_model)
    n_vis = ForwardCount(be.model.visual)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    try:
        vlm.main(argv + ["--output_dir", str(out_dir), "--device", "cuda"], backend=capped)
    finally:
        be._decode_row = decode_row
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    n_text.remove()
    n_vis.remove()
    check_launches(f"vlm_direct {tag}", launches, {
        "frame_flash_attention": len(be.model.visual.blocks) * n_vis.n,
        "linear_w4a8": 7 * len(be.model.language_model.layers) * n_text.n,
        "decode_attention": k10_launches(be.model, n_text, be.generator.kv_dtype)})
    n_req = n_patients * len(VLM_DIRECT_TEMPS)
    if (len(capped.texts) != n_req or n_vis.n != n_req or len(rows) != n_req
            or not all(isinstance(t, str) and t.strip() for t in capped.texts)):
        fail(f"vlm_direct {tag}: {len(capped.texts)} outputs for {n_req} requests, "
             f"{n_vis.n} vision forwards, {[len(t) for t in capped.texts]} chars")
    res = json.loads((out_dir / "vlm_direct_judging_results.json").read_text(encoding="utf-8"))
    summ = json.loads((out_dir / "summary.json").read_text(encoding="utf-8"))
    fold = res.get("folds", {}).get(fold_key, {})
    temps = {f"temp_{t}" for t in VLM_DIRECT_TEMPS}
    if (set(res) != VLM_RESULTS_KEYS or set(res["config"]) != VLM_CONFIG_KEYS
            or list(res["folds"]) != [fold_key] or set(fold) != VLM_FOLD_KEYS
            or len(fold["sampled_patient_ids"]) != n_patients
            or set(fold["predictions"]) != temps or set(summ) != VLM_SUMMARY_KEYS
            or not temps <= set(summ["average_metrics"])
            or summ["total_samples"] != n_patients):
        fail(f"vlm_direct {tag}: artifacts {sorted(res)} {sorted(fold)} {sorted(summ)}")
    tokens = useful_tokens(rows, [CAPPED_NEW_TOKENS] * len(rows), be.generator.eos_token_id)
    parsed = sum(len(p) for p in fold["predictions"].values())
    print(f"vlm_direct {tag} (int4 judge, {n_patients} patients x temperatures "
          f"{list(VLM_DIRECT_TEMPS)}, max_new_tokens capped at {CAPPED_NEW_TOKENS} of "
          f"2,048): {n_req} requests in {wall:.3f} s (host clock), "
          f"{n_req / wall:.3f} cases/s, {tokens / wall:.1f} tokens/s ({tokens} tokens); "
          f"{n_vis.n} vision and {n_text.n} decoder forwards; {parsed} answers parsed "
          f"(random weights); launches {launches} ({card})", flush=True)
    return {"rows": rows, "wall_s": wall, "launches": launches, "tokens": tokens,
            "cases_per_s": n_req / wall, "tokens_per_s": tokens / wall}


def vlm_direct_phase(work: Path, manifest_path: Path, be, card: str) -> dict:
    """The VLM direct-judging baseline's CLI on the int4 judge: 4 cohort
    patients at temperatures 0.0 and 0.7, sequentially, then streamed
    (``--serving continuous --n_slots 4``: each greedy stream equal to the
    sequential one or first differing at a near-tie), then the fold
    protocol on the cohort's card CV experiment. Returns the launch counts
    by run and the rates."""
    from emr2a_tpu_torch.baselines.vlm_direct.run_vlm_direct_judging import (
        VLMDirectJudgingBaseline,
    )
    from emr2a_tpu_torch.data.manifest import load_manifest

    base = ["--manifest", str(manifest_path), "--temperatures", *VLM_DIRECT_TEMPS,
            "--n_samples_per_fold", str(VLM_DIRECT_PATIENTS), "--random_seed", "42"]
    runs = {
        "sequential": vlm_direct_run("sequential", be, base, work / "vlm_seq", "all_patients",
                                     VLM_DIRECT_PATIENTS, card),
        "continuous": vlm_direct_run("continuous", be, base + [
            "--serving", "continuous", "--n_slots", "4"], work / "vlm_cont", "all_patients",
            VLM_DIRECT_PATIENTS, card)}
    exp = work / "cv" / "cuda" / "exp_cohort"
    fold_ids = json.loads((exp / "fold_1" / "metrics.json").read_text(encoding="utf-8"))[
        "test_patient_ids"]
    runs["fold"] = vlm_direct_run("fold 0", be, [
        "--manifest", str(manifest_path), "--temperatures", *VLM_DIRECT_TEMPS, "--fold", "0",
        "--experiment_dir", str(exp)], work / "vlm_fold", "fold_0", len(fold_ids), card)

    # the greedy requests (the first VLM_DIRECT_PATIENTS of each run's grid)
    sampled = json.loads((work / "vlm_seq" / "vlm_direct_judging_results.json").read_text(
        encoding="utf-8"))["folds"]["all_patients"]["sampled_patient_ids"]
    by_id = {r["patient_id"]: r for r in load_manifest(manifest_path)}
    baseline = VLMDirectJudgingBaseline(backend=be)
    requests = [{**baseline.build_request(by_id[p], 0.0),
                 "max_new_tokens": CAPPED_NEW_TOKENS} for p in sampled]
    greedy = range(VLM_DIRECT_PATIENTS)
    ties = near_ties("vlm_direct continuous", be, requests, runs["continuous"]["rows"],
                     runs["sequential"]["rows"], greedy, 0.75)
    equal = len(greedy) - len(ties)
    print(f"vlm_direct continuous 4 slots: {equal} of {len(greedy)} greedy streams equal the "
          f"sequential ones; near-ties at the first difference (request, token, B = 1 "
          f"top-two gap) {ties} (limit 0.75) ({card})", flush=True)
    return {"counts": {f"vlm_direct {tag}": r["launches"] for tag, r in runs.items()},
            "rates": {tag: {k: r[k] for k in ("wall_s", "cases_per_s", "tokens_per_s",
                                               "tokens")} for tag, r in runs.items()}}


CNN_BATCH, CNN_K, CNN_SIZE, CNN_LR, CNN_WD = 8, 4, 224, 1e-4, 1e-5
CNN_EPS = 1e-8      # torch.optim.Adam's and optax.adam's eps
CNN_RESULTS_KEYS = {"model_type", "k_slices", "cv_folds", "seed", "fold_results",
                    "mean_accuracy", "std_accuracy", "min_accuracy", "max_accuracy",
                    "mean_precision", "std_precision", "mean_recall", "std_recall",
                    "mean_f1", "std_f1"}
CNN_FOLD_KEYS = {"loss", "accuracy", "precision", "recall", "f1", "confusion_matrix", "fold"}


def cnn_step_check(model_type: str, backbone: dict, batch: tuple, card: str) -> None:
    """One train step of ``model_type`` from the same weights and batch on
    the card (f32) and on the CPU (f32, and f64 as the reference): the
    loss within rtol 1e-4 of the CPU's; each parameter's gradient as close
    to the f64 one as the CPU's f32 gradient is (norm-relative, within 4 x
    its error plus 1e-6: BatchNorm's parameter gradients are sums over up
    to 100,000 terms that cancel, so both f32 devices carry errors near 1 %
    there); the running statistics within atol = rtol = 1e-4; and the
    updated parameters. Adam's first step moves each element by lr times
    g / (|g| + eps), g with the weight decay added: where the two devices'
    g have one sign and exceed 100 eps, both steps are lr within 1 %, so
    there every element must agree within lr/10, and such elements must be
    at least 90 % of all (99.92 % and 99.56 % on the H100); elsewhere a
    gradient below the rounding may step either way, 2 lr apart, and at
    most 1 % of all elements may differ by more than lr/10 (0.04 % and
    0.10 % on the H100)."""
    from emr2a_tpu_torch.baselines.cnn import train_cnn_baseline as cnn

    out, w0 = {}, None
    for tag, dev, dtype in (("cuda", "cuda", torch.float32), ("cpu", "cpu", torch.float32),
                            ("cpu64", "cpu", torch.float64)):
        model = cnn.build_model(model_type, 4, dev, seed=0, pretrained_backbone=backbone)
        model.to(dtype)
        if w0 is None:
            w0 = {k: p.detach().cpu().double() for k, p in model.named_parameters()}
        opt = torch.optim.Adam(model.parameters(), lr=CNN_LR, weight_decay=CNN_WD)
        step, _ = cnn.make_steps(model, opt, model_type == "multimodal")
        loss, _ = step(*batch)
        out[tag] = (float(loss), {k: v.detach().cpu() for k, v in model.state_dict().items()},
                    {k: p.grad.cpu().double() for k, p in model.named_parameters()})
    (loss_c, card_sd, card_g), (loss_h, cpu_sd, cpu_g) = out["cuda"], out["cpu"]
    ref = out["cpu64"][2]

    def rel(g, k):
        return float((g[k] - ref[k]).norm() / ref[k].norm())

    errs = sorted(((rel(card_g, k) - 4 * rel(cpu_g, k), rel(card_g, k), rel(cpu_g, k), k)
                   for k in ref), reverse=True)
    print(f"cnn {model_type} gradients against f64, worst tensors (card f32, CPU f32 "
          f"norm-relative): {[(f'{c:.2e}', f'{h:.2e}', k) for _, c, h, k in errs[:5]]}",
          flush=True)
    bad = [(k, c, h) for _, c, h, k in errs if not c <= 4 * h + 1e-6]
    param_err, stats_err, sure_err, n_sure, n_far, n = 0.0, 0.0, 0.0, 0, 0, 0
    for name, want in cpu_sd.items():
        d = (card_sd[name] - want).abs()
        if "running" in name:
            stats_err = max(stats_err, float(d.max()))
            if not torch.allclose(card_sd[name], want, atol=1e-4, rtol=1e-4):
                fail(f"cnn {model_type} step: {name} differs from the CPU's by {float(d.max())}")
            continue
        gc, gh = card_g[name] + CNN_WD * w0[name], cpu_g[name] + CNN_WD * w0[name]
        sure = (gc * gh > 0) & (gc.abs() > 100 * CNN_EPS) & (gh.abs() > 100 * CNN_EPS)
        param_err = max(param_err, float(d.max()))
        if sure.any():
            sure_err = max(sure_err, float(d[sure].max()))
        n_sure += int(sure.sum())
        n_far += int((~(d <= CNN_LR / 10)).sum())
        n += d.numel()
    if (not abs(loss_c - loss_h) <= 1e-4 * abs(loss_h) or bad or not sure_err <= CNN_LR / 10
            or not n_sure >= 0.9 * n or not n_far <= 1e-2 * n):
        fail(f"cnn {model_type} step: loss {loss_c} vs CPU {loss_h}, gradients farther from "
             f"f64 than 4 x the CPU's {bad[:3]}, params where both gradients agree max err "
             f"{sure_err} (limit {CNN_LR / 10}) on {n_sure} of {n} elements (at least "
             f"90 %), {n_far} beyond lr/10 (limit 1 %)")
    print(f"cnn {model_type} train step at full size ({CNN_BATCH} x {CNN_K} slices of "
          f"{CNN_SIZE}², f32, TF32 off), card vs CPU from the same weights and batch: loss "
          f"{loss_c:.6f} vs {loss_h:.6f} (f64 {out['cpu64'][0]:.6f}), gradients against f64 "
          f"at most {max(e[1] for e in errs):.2e} on the card, {max(e[2] for e in errs):.2e} "
          f"on the CPU (norm-relative); updated params: on the {n_sure} of {n} elements "
          f"({n_sure / n:.4f}, at least 0.9) whose gradients agree in sign beyond 100 eps, "
          f"max abs err {sure_err:.3e} (limit "
          f"lr/10 = {CNN_LR / 10:.1e}); {n_far} elements ({n_far / n:.2e}) beyond lr/10 "
          f"(limit 1e-2), max abs err {param_err:.3e}; running stats max abs err "
          f"{stats_err:.3e} (limit 1e-4) ({card})", flush=True)


def cnn_phase(work: Path, manifest_path: Path, card: str) -> dict:
    """The CNN baseline at full size: a seeded torchvision-layout ResNet18
    (random BN statistics) converted, its eval backbone on the card against
    the CPU (atol 2e-4, rtol 1e-3); one train step of both models card
    against CPU; the train step's ms (CUDA events, median of 10 after
    warm-up), images/s (``ThroughputMeter``), peak GiB (above what was live
    at the phase's start) and one ``trace_to`` capture of it (the kernels'
    device time by name); then the CLI on the cohort (3 folds, 2 epochs,
    both models, ``--pretrained_path``), its results.json and
    ``compute_cnn_metrics`` on it; no port kernel launched."""
    import io

    from emr2a_tpu_torch.baselines.cnn import compute_cnn_metrics
    from emr2a_tpu_torch.baselines.cnn import train_cnn_baseline as cnn
    from emr2a_tpu_torch.models.convert import convert_torch_resnet18, load_state_dict
    from emr2a_tpu_torch.models.resnet import ResNet18
    from emr2a_tpu_torch.tools.torchvision_resnet import torchvision_resnet18
    from emr2a_tpu_torch.utils import ThroughputMeter, annotate, trace_to

    ckpt = work / "resnet18.pth"
    torch.save(torchvision_resnet18(seed=0).state_dict(), ckpt)
    backbone = convert_torch_resnet18(load_state_dict(ckpt))
    g = torch.Generator().manual_seed(14)
    x = torch.randn(CNN_BATCH, CNN_SIZE, CNN_SIZE, 3, generator=g)
    feats = {}
    for dev in ("cuda", "cpu"):
        m = ResNet18()
        m.load_state_dict(backbone)
        with torch.no_grad():
            feats[dev] = m.to(dev).eval()(x.to(dev)).cpu()
    err = float((feats["cuda"] - feats["cpu"]).abs().max())
    if not torch.allclose(feats["cuda"], feats["cpu"], atol=2e-4, rtol=1e-3):
        fail(f"converted ResNet18 backbone: card vs CPU max abs err {err}")
    print(f"convert_torch_resnet18 (seeded torchvision-layout ResNet18, random BN stats): "
          f"eval backbone on {CNN_BATCH} x {CNN_SIZE}² card vs CPU max abs err {err:.3e} "
          f"(atol 2e-4, rtol 1e-3) ({card})", flush=True)

    images = torch.randn(CNN_BATCH, CNN_K, CNN_SIZE, CNN_SIZE, 3, generator=g).numpy()
    clinical = torch.randn(CNN_BATCH, 3, generator=g).numpy()
    labels = np.arange(CNN_BATCH) % 4
    for model_type in ("image_only", "multimodal"):
        cnn_step_check(model_type, backbone, (images, clinical, labels), card)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    live = torch.cuda.memory_allocated()
    model = cnn.build_model("image_only", 4, "cuda", pretrained_backbone=backbone)
    opt = torch.optim.Adam(model.parameters(), lr=CNN_LR, weight_decay=CNN_WD)
    step, _ = cnn.make_steps(model, opt, False)
    batch = tuple(torch.as_tensor(a).cuda() for a in (images, clinical, labels))
    reset_counts()
    ms = median_ms(lambda: step(*batch), iters=10, warmup=3)
    meter = ThroughputMeter("images")
    for _ in range(10):
        loss, _ = step(*batch)
        meter.add(CNN_BATCH * CNN_K, loss)
    peak = (torch.cuda.max_memory_allocated() - live) / 2 ** 30
    with trace_to(str(work / "cnn_trace")) as prof:
        with annotate("cnn_train_step"):
            step(*batch)
        torch.cuda.synchronize()
    # the kernels' own device time (aten ops attribute theirs; the annotated
    # ranges, ours and the optimizer's, span them)
    ops = sorted(((e.self_device_time_total / 1e3, e.key[:48]) for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)
                  and e.self_device_time_total > 0), reverse=True)
    device_ms = sum(t for t, _ in ops)
    launches = read_counts()
    check_launches("cnn train steps", launches, {})
    traces = list((work / "cnn_trace").glob("*.pt.trace.json"))
    if len(traces) != 1 or '"cnn_train_step"' not in traces[0].read_text():
        fail(f"trace_to: {traces} does not name the annotated stage")
    print(f"cnn image_only train step ({CNN_BATCH} x {CNN_K} x {CNN_SIZE}², Adam): "
          f"{ms:.3f} ms (CUDA events, median of 10 after 3 warm-up), "
          f"{meter.rate:.1f} images/s over 10 steps (ThroughputMeter), peak "
          f"{peak:.2f} GiB above the {live / 2 ** 30:.2f} GiB live before; trace_to wrote {traces[0].name} "
          f"({traces[0].stat().st_size / 2 ** 20:.1f} MiB, names cnn_train_step): kernels' "
          f"device time {device_ms:.3f} ms a step (busy {device_ms / ms:.2f} of the median), "
          f"top {[(k, round(t, 3)) for t, k in ops[:6]]}; launches "
          f"{launches} ({card})", flush=True)
    del model, opt, step, batch

    results = {}
    for model_type in ("image_only", "multimodal"):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        cnn.main(["--manifest_path", str(manifest_path), "--output_dir", str(work / "cnn_cli"),
                  "--model_type", model_type, "--cv_folds", "3", "--epochs", "2",
                  "--pretrained", "--pretrained_path", str(ckpt), "--device", "cuda"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check_launches(f"cnn CLI {model_type}", read_counts(), {})
        path = work / "cnn_cli" / f"exp_{model_type}" / "results.json"
        res = json.loads(path.read_text())
        if (set(res) != CNN_RESULTS_KEYS or len(res["fold_results"]) != 3
                or any(set(f) != CNN_FOLD_KEYS or np.shape(f["confusion_matrix"]) != (4, 4)
                       for f in res["fold_results"])):
            fail(f"cnn CLI {model_type}: results.json {sorted(res)}")
        report = io.StringIO()
        with contextlib.redirect_stdout(report):
            compute_cnn_metrics.main(["--results_path", str(path)])
        if not all(f"| {c:9s} |" in report.getvalue() for c in compute_cnn_metrics.CLASSES):
            fail(f"compute_cnn_metrics on {model_type}: {report.getvalue()[:200]}")
        results[model_type] = wall
        print(f"cnn CLI {model_type} (cohort, 3 folds, 2 epochs, --pretrained_path): "
              f"{wall:.2f} s (host clock, decode included); mean accuracy "
              f"{res['mean_accuracy']:.2f} % (random weights); results.json with JAX's keys; "
              f"compute_cnn_metrics reported 4 classes ({card})", flush=True)
    return {"step_ms": ms, "images_per_s": meter.rate, "peak_gib": peak, "cli_s": results}


TRAIN_BATCH, TRAIN_LR = 32, 1e-4


def trainer_towers(cfg, device: str):
    """BioMedCLIP's towers, random weights from seed 0 (drawn on the CPU)."""
    from emr2a_tpu_torch.models.clip import (
        BioMedCLIPImageTower,
        BioMedCLIPTextTower,
        init_tower,
    )
    gen = torch.Generator().manual_seed(0)
    image = init_tower(BioMedCLIPImageTower(cfg), gen).to(device)
    text = init_tower(BioMedCLIPTextTower(cfg), gen).to(device)
    return image, text


def trainer_run(trainer, params: dict, batch: tuple, steps: int, state=None):
    """``steps`` train steps (from ``init_state(params)`` unless a state is
    given): (state, losses, step ms by CUDA events)."""
    state = state or trainer.init_state(params)
    step = trainer.make_train_step()
    losses, times = [], []
    for _ in range(steps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        state, loss = step(state, *batch)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        losses.append(float(loss))
    return state, losses, times


def trainer_phase(work: Path, card: str) -> dict:
    """The contrastive trainer at BioMedCLIP's full width (ViT-B/16 and
    PubMedBERT-256, unfused, f32, batch 32, the stub tokenizer): 3 steps on
    a fixed batch (loss finite and lower after 3 steps than before, JAX's
    test's criterion; no port kernel launched),
    ``remat=True`` equal to plain within 1e-5, resume on the card exact
    (2 + save + restore + 2 against 4 straight, rtol 1e-5), card against
    CPU at 2 layers a tower (each of 3 losses within rtol 1e-4), and the
    refusal of fused towers."""
    from emr2a_tpu_torch.encoders.biomedclip_encoder import default_biomedclip_config
    from emr2a_tpu_torch.models.clip import BioMedCLIPImageTower
    from emr2a_tpu_torch.training import ContrastiveTrainer

    cfg = default_biomedclip_config()
    v, t = cfg.vision, cfg.text
    if not (v.hidden_size == 768 and v.num_layers == 12 and v.mlp_dim == 3072
            and t.hidden_size == 768 and t.num_layers == 12 and not v.fused_attn
            and not v.fused_mlp and v.dtype == torch.float32):
        fail("the trainer's towers are not BioMedCLIP's, unfused, in f32")
    g = torch.Generator().manual_seed(7)
    tok = CharTokenizer()(clinical_texts(TRAIN_BATCH), max_length=256)
    host = (torch.randn(TRAIN_BATCH, 224, 224, 3, generator=g),
            torch.as_tensor(tok["input_ids"]), torch.as_tensor(tok["attention_mask"]))
    batch = tuple(a.cuda() for a in host)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    live = torch.cuda.memory_allocated()
    image, text = trainer_towers(cfg, "cuda")
    params = {"image": dict(image.state_dict()), "text": dict(text.state_dict())}
    torch.cuda.synchronize()
    reset_counts()
    plain = ContrastiveTrainer(image, text, learning_rate=TRAIN_LR)
    _, losses, times = trainer_run(plain, params, batch, 4)
    torch.cuda.synchronize()
    launches = read_counts()
    check_launches("trainer", launches, {})
    if not (np.isfinite(losses).all() and losses[2] < losses[0]):
        fail(f"trainer: losses {losses[:3]} not finite or not lower after 3 steps")
    _, remat, _ = trainer_run(ContrastiveTrainer(image, text, learning_rate=TRAIN_LR,
                                                 remat=True), params, batch, 3)
    if not np.allclose(remat, losses[:3], rtol=1e-5, atol=0):
        fail(f"trainer remat=True: losses {remat} vs plain {losses[:3]}")
    s2, _, _ = trainer_run(plain, params, batch, 2)
    plain.save_state(s2, work / "train_state")
    s3 = plain.restore_state(plain.init_state(params), work / "train_state")
    _, resumed, _ = trainer_run(plain, params, batch, 2, state=s3)
    if s3.step != 2 or not np.allclose(resumed, losses[2:], rtol=1e-5, atol=0):
        fail(f"trainer resume: {resumed} vs straight {losses[2:]}")
    peak = (torch.cuda.max_memory_allocated() - live) / 2 ** 30
    ms = float(np.median(times[1:]))
    print(f"trainer at BioMedCLIP width (ViT-B/16 + PubMedBERT-256 unfused, f32, batch "
          f"{TRAIN_BATCH}, AdamW lr {TRAIN_LR}): losses {[round(x, 6) for x in losses]}; "
          f"step {ms:.2f} ms (CUDA events, median of steps 2 to 4), peak {peak:.2f} GiB above "
          f"the {live / 2 ** 30:.2f} GiB live before; "
          f"remat=True losses {[round(x, 6) for x in remat]} (within 1e-5); 2 steps + "
          f"save + restore + 2 = {[round(x, 6) for x in resumed]} (4 straight "
          f"{[round(x, 6) for x in losses[2:]]}, rtol 1e-5); launches {launches} ({card})",
          flush=True)
    del image, text, params, plain, s2, s3
    torch.cuda.empty_cache()

    cut = dataclasses.replace(cfg, vision=dataclasses.replace(v, num_layers=2),
                              text=dataclasses.replace(t, num_layers=2))
    cut_losses = {}
    for dev, data in (("cuda", batch), ("cpu", host)):
        image, text = trainer_towers(cut, dev)
        trainer = ContrastiveTrainer(image, text, learning_rate=TRAIN_LR)
        state = trainer.init_state({"image": dict(image.state_dict()),
                                    "text": dict(text.state_dict())})
        step = trainer.make_train_step()
        cut_losses[dev] = []
        for _ in range(3):
            state, loss = step(state, *data)
            cut_losses[dev].append(float(loss))
    if not np.allclose(cut_losses["cuda"], cut_losses["cpu"], rtol=1e-4, atol=0):
        fail(f"trainer at 2 layers: card {cut_losses['cuda']} vs CPU {cut_losses['cpu']}")
    fused = BioMedCLIPImageTower(dataclasses.replace(
        cut, vision=dataclasses.replace(cut.vision, fused_attn=True, fused_mlp=True)))
    try:
        ContrastiveTrainer(fused, text).init_state({"image": {}, "text": {}})
        fail("trainer: a tower with fused blocks was not refused")
    except ValueError as e:
        refused = str(e)
    print(f"trainer card vs CPU at 2 layers a tower (full width, batch {TRAIN_BATCH}): "
          f"losses {cut_losses['cuda']} vs {cut_losses['cpu']} (rtol 1e-4); a fused tower "
          f"refused: {refused[:80]!r} ({card})", flush=True)
    return {"step_ms": ms, "peak_gib": peak, "losses": losses}


BRINGUP_KEYS = {"model_path", "load_convert_s", "image_tap_dim", "image_tap_s", "text_dim",
                "text_s", "generate_s", "generated", "tokenizer_roundtrip_ok"}


def bringup_phase(work: Path, card: str) -> dict:
    """``bringup_qwen3_vl`` on the checkpoint directory that
    ``qwen_encoder_phase`` wrote (the judge's weights cut to 2 vision
    blocks and 2 text layers at the 8B's widths), with the stub tokenizer,
    twice: cold (its converted-params cache, left by the judge phase's
    loads, removed first: one read of the checkpoint, the cache written),
    then cached (no read of the checkpoint). Each: JAX's summary keys, the
    8B's tap and text widths, text generated, no kernel launched but K10
    in the generation's decode steps (bf16, one image a forward); the two
    generate the same text."""
    import shutil

    from emr2a_tpu_torch.judge.qwen_backend import QwenVLBackend
    from emr2a_tpu_torch.models import checkpoint
    from emr2a_tpu_torch.models.convert import bringup_qwen3_vl
    from emr2a_tpu_torch.tools.stub_tokenizer import WordTokenizer

    ckpt = work / "qwen_ckpt"
    for cache in ckpt.glob("emr2a_torch.*"):
        shutil.rmtree(cache)
    reads, read = [0], checkpoint.load_state_dict

    def counting(path):
        reads[0] += 1
        return read(path)

    # the backend is built inside the call: count its decoder's forwards
    # from its generate
    k10, generate = [], QwenVLBackend.generate

    def counted(self, *args, **kw):
        n_text = ForwardCount(self.model.language_model)
        try:
            return generate(self, *args, **kw)
        finally:
            n_text.remove()
            k10.append(k10_launches(self.model, n_text, self.generator.kv_dtype))

    runs = {}
    checkpoint.load_state_dict = counting
    QwenVLBackend.generate = counted
    try:
        for tag in ("cold", "cached"):
            torch.cuda.synchronize()
            reset_counts()
            k10.clear()
            before, t0 = reads[0], time.perf_counter()
            summary = bringup_qwen3_vl(ckpt, max_new_tokens=16, tokenizer=WordTokenizer(),
                                       device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = read_counts()
            if len(k10) != 1:
                fail(f"bringup_qwen3_vl {tag}: {len(k10)} generations, expected 1")
            check_launches(f"bringup_qwen3_vl {tag}", launches, {"decode_attention": k10[0]})
            if (set(summary) != BRINGUP_KEYS or summary["image_tap_dim"] != 1152
                    or summary["text_dim"] != 4096 or not summary["generated"].strip()):
                fail(f"bringup_qwen3_vl {tag}: {summary}")
            runs[tag] = {"summary": summary, "wall_s": wall, "checkpoint_reads": reads[0] - before}
            print(f"bringup_qwen3_vl {tag} on {ckpt.name} (depth 2 at the 8B's widths, stub "
                  f"tokenizer): {wall:.2f} s, load_convert_s {summary['load_convert_s']}, "
                  f"checkpoint reads {reads[0] - before}; summary "
                  f"{json.dumps({k: v for k, v in summary.items() if k != 'model_path'}, ensure_ascii=False)} "
                  f"(tokenizer_roundtrip_ok is the stub's honest answer); launches {launches} "
                  f"({card})", flush=True)
            torch.cuda.empty_cache()
    finally:
        checkpoint.load_state_dict = read
        QwenVLBackend.generate = generate
    caches = sorted(p.name for p in ckpt.glob("emr2a_torch.*"))
    if (runs["cold"]["checkpoint_reads"], runs["cached"]["checkpoint_reads"]) != (1, 0):
        fail(f"bringup_qwen3_vl: checkpoint reads cold {runs['cold']['checkpoint_reads']}, "
             f"cached {runs['cached']['checkpoint_reads']} (want 1 and 0)")
    if runs["cold"]["summary"]["generated"] != runs["cached"]["summary"]["generated"]:
        fail(f"bringup_qwen3_vl: the cached load generated other text: "
             f"{runs['cached']['summary']['generated']!r} against "
             f"{runs['cold']['summary']['generated']!r}")
    print(f"bringup_qwen3_vl converted-params cache {caches}: load_convert_s cold "
          f"{runs['cold']['summary']['load_convert_s']} s, cached "
          f"{runs['cached']['summary']['load_convert_s']} s; the same 16 greedy tokens "
          f"({card})", flush=True)
    return runs


def baselines_phase(work: Path, manifest_path: Path, card: str, stages) -> dict:
    """The CNN baseline, the trainer and the bring-up CLI (the VLM
    baseline ran inside the judge phase), each a stage of ``stages`` (a
    ``StageTimer``), whose summary it prints."""
    t0 = time.time()
    with stages.stage("cnn_baseline"):
        cnn = cnn_phase(work, manifest_path, card)
    torch.cuda.empty_cache()
    with stages.stage("trainer"):
        trainer = trainer_phase(work, card)
    torch.cuda.empty_cache()
    with stages.stage("bringup_qwen3_vl"):
        bringup = bringup_phase(work, card)
    torch.cuda.empty_cache()
    for name, s in sorted(stages.summary().items()):
        print(f"StageTimer {name}: {s['total_s']:.2f} s ({s['calls']} call)", flush=True)
    print(f"baselines phase (CNN, trainer, bring-up) in {time.time() - t0:.1f} s", flush=True)
    return {"cnn": cnn, "trainer": trainer, "bringup": bringup}


def judge_phase(work: Path, manifest_path: Path, card: str, stages) -> dict:
    """The 8B judge in three precisions, the reduced-depth check and step4,
    serving, the VLM direct baseline (a stage of ``stages``), speculative
    decoding and AWQ, and the review. Returns the launch counts of each
    judge path."""
    from PIL import Image

    from emr2a_tpu_torch.data.manifest import load_manifest
    from emr2a_tpu_torch.judge.audit import VLMAuditModule
    from emr2a_tpu_torch.judge.qwen_backend import QwenVLBackend
    from emr2a_tpu_torch.models.qwen3_vl import qwen3_vl_8b_config, random_state
    from emr2a_tpu_torch.pipelines.step4_vlm_review.run import run_vlm_audit_pipeline
    from emr2a_tpu_torch.tools.stub_tokenizer import WordTokenizer

    cfg = qwen3_vl_8b_config(torch.bfloat16)
    t0 = time.time()
    state = random_state(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"Qwen3-VL-8B random weights (seed 0) on the card in {time.time() - t0:.1f} s: "
          f"{sum(t.numel() for t in state.values()) / 1e9:.3f} B parameters", flush=True)
    tok = WordTokenizer()
    backends = {}
    for prec in ("bf16", "int8", "int4"):
        t0 = time.time()
        backends[prec] = QwenVLBackend(config=cfg, params=state, tokenizer=tok,
                                       precision=prec)
        torch.cuda.synchronize()
        print(f"judge {prec}: backend built in {time.time() - t0:.1f} s", flush=True)
    m = backends["bf16"].model
    v, t = m.config.vision, m.config.text
    if not (len(m.visual.blocks) == 27 and v.hidden_size == 1152 and v.num_heads == 16
            and v.intermediate_size == 4304 and v.out_hidden_size == 4096
            and v.deepstack_visual_indexes == (8, 16, 24) and len(m.language_model.layers) == 36
            and t.hidden_size == 4096 and t.num_heads == 32 and t.num_kv_heads == 8
            and t.head_dim == 128 and t.intermediate_size == 12288
            and t.vocab_size == 151936 and not t.tie_word_embeddings):
        fail("the judge is not Qwen3-VL-8B at full width")

    manifest = load_manifest(manifest_path)
    audit = VLMAuditModule(backend=backends["bf16"])
    neighbors = [(r["patient_id"], r["label"], 0.9 - 0.05 * i)
                 for i, r in enumerate(manifest[1:6])]
    evidence = audit.construct_evidence_package(manifest[0], neighbors, manifest, work)
    request = audit._build_audit_request(evidence, manifest[0]["label"])
    if len(request["images"]) != 7:
        fail(f"the audit request has {len(request['images'])} images, expected 7")
    runs = {prec: judge_request(prec, be, request, card) for prec, be in backends.items()}

    # the generator's options on the int4 judge, the same request
    from emr2a_tpu_torch.models.qwen3_vl import Qwen3VLGenerator
    base = backends["int4"]
    chunked = f"int4 prefill_chunk={OPTION_CHUNK}"
    for tag, kw in (("int4 kv_dtype=int8", {"kv_dtype": "int8"}),
                    (chunked, {"prefill_chunk": OPTION_CHUNK})):
        be = copy.copy(base)
        be.decode_chunk = DECODE_TOKENS      # no decode steps past the timed ones
        be.generator = Qwen3VLGenerator(base.model, eos_token_id=base.generator.eos_token_id,
                                        **kw)
        runs[tag] = judge_request("int4", be, request, card, tag=tag)
    chunks = runs[chunked]["padded"] // OPTION_CHUNK
    if runs[chunked]["forwards"] != chunks + DECODE_TOKENS:
        fail(f"{chunked}: {runs[chunked]['forwards']} decoder forwards, expected "
             f"{chunks + DECODE_TOKENS} ({chunks} prefill chunks, {DECODE_TOKENS} steps)")
    sampled = sampled_phase(base, request, card)

    images = [Image.open(p).convert("RGB").resize((256, 256))
              for p in evidence["query_images"][:2]]
    reduced_depth_check(cfg, state, images, card)
    model_axis_check(cfg, state, card)
    qwen = qwen_encoder_phase(work, manifest_path, cfg, state, m, images, card)

    be = backends["int4"]
    n_text = ForwardCount(be.model.language_model)
    n_vis = ForwardCount(be.model.visual)
    exp_dir = work / "cv" / "cuda" / "exp_cohort"
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.time()
    run_vlm_audit_pipeline(exp_dir, manifest_path, work / "step4", max_samples=STEP4_CASES,
                           backend=be, vlm_max_new_tokens=STEP4_NEW_TOKENS)
    torch.cuda.synchronize()
    wall = time.time() - t0
    step4 = read_counts()
    n_text.remove()
    n_vis.remove()
    check_launches("step4", step4, {
        "frame_flash_attention": len(be.model.visual.blocks) * n_vis.n,
        "linear_w4a8": 7 * len(be.model.language_model.layers) * n_text.n,
        "decode_attention": k10_launches(be.model, n_text, be.generator.kv_dtype)})
    summary = json.loads((work / "step4" / "vlm_audit_summary.json").read_text())
    details = (work / "step4" / "vlm_audit_details.jsonl").read_text().splitlines()
    if n_vis.n != STEP4_CASES or len(details) != STEP4_CASES or \
            len(summary["audit_results"]) != STEP4_CASES or "metrics" not in summary:
        fail(f"step4: {n_vis.n} vision forwards, {len(details)} detail rows")
    print(f"step4 (int4 judge): {STEP4_CASES} cases, {STEP4_NEW_TOKENS} new tokens each, "
          f"in {wall:.2f} s (host clock); {n_text.n} decoder forwards; decisions "
          f"{summary['audit_summary']}; launches {step4}; artifacts written ({card})",
          flush=True)
    t0 = time.time()
    serving = serving_phase(work, manifest_path, backends, card)
    print(f"serving phase in {time.time() - t0:.1f} s", flush=True)
    t0 = time.time()
    with stages.stage("vlm_direct"):
        vlm_direct = vlm_direct_phase(work, manifest_path, be, card)
    print(f"vlm_direct phase in {time.time() - t0:.1f} s", flush=True)
    # the judges' kept graphs and slot states go, and the int8 judge, which
    # the later phases do not use
    for judge in backends.values():
        judge.generator.release()
        for batcher in judge._batchers.values():
            batcher.release()
    del backends["int8"]
    torch.cuda.empty_cache()
    spec = spec_awq_phase(work, manifest_path, cfg, state, backends, request, runs, serving,
                          card)
    review = review_phase(work, manifest_path, be, card)
    del backends, state, be, base, m
    torch.cuda.empty_cache()
    return {"runs": runs, "step4": step4, "sampled": sampled, "review": review, "qwen": qwen,
            "serving": serving, "spec": spec, "vlm_direct": vlm_direct}


def step1_phase(work: Path) -> Path:
    """The synthetic cohort on disk, then the port's step1 on its raw tree
    (Case_csv + CT_2D_image_core): every patient matched, the cohort's
    patients, labels and slices in natural order. Returns step1's
    manifest, which the later phases read."""
    from emr2a_tpu_torch.pipelines.step1_manifest import build_manifest as step1
    from emr2a_tpu_torch.tools.cohort import write_cohort

    t0 = time.time()
    written = write_cohort(work / "cohort")
    print(f"cohort written in {time.time() - t0:.1f} s", flush=True)
    t0 = time.time()
    step1.main(["--data_root", str(work / "cohort"), "--out_dir", str(work / "step1"),
                "--relative_paths", "false"])
    wall = time.time() - t0
    manifest_path = work / "step1" / "manifest.jsonl"
    want = [json.loads(line) for line in written.read_text(encoding="utf-8").splitlines()]
    got = [json.loads(line) for line in manifest_path.read_text(encoding="utf-8").splitlines()]
    by_id = {r["patient_id"]: r for r in got}
    if sorted(by_id) != sorted(r["patient_id"] for r in want) or len(got) != len(want):
        fail(f"step1: patients {sorted(by_id)}")
    for r in want:
        g = by_id[r["patient_id"]]
        if g["label"] != r["label"] or g["slices"] != r["slices"] or g["match_by"] != "name":
            fail(f"step1: {r['patient_id']} differs from the cohort's record")
    missing = [f for f in ("missing_in_fs.csv", "missing_in_csv.csv")
               if (work / "step1" / f).exists()]
    if missing:
        fail(f"step1: unmatched patients ({missing})")
    print(f"step1: {len(got)} patients matched from the raw tree in {wall:.2f} s "
          f"(host); slices in natural order ({Path(got[0]['slices'][9]).name}, "
          f"{Path(got[0]['slices'][10]).name}); meta keys {sorted(got[0]['meta'])}",
          flush=True)
    return manifest_path


def step3_phase(work: Path, emb_path: Path, manifest_path: Path) -> None:
    """The port's step3 on step2's embeddings, on the card and with
    --device cpu: the two retrieval_results.json must be equal."""
    from emr2a_tpu_torch.pipelines.step3_retrieval import evaluate_retrieval as step3

    for dev in ("cuda", "cpu"):
        step3.main(["--manifest_path", str(manifest_path), "--embeddings_path",
                    str(emb_path), "--output_dir", str(work / "step3" / dev),
                    "--test_size", "0.3", "--device", dev])
    card, cpu = ((work / "step3" / dev / "retrieval_results.json").read_text(encoding="utf-8")
                 for dev in ("cuda", "cpu"))
    if card != cpu:
        fail("step3: retrieval_results.json differs between the card and the CPU")
    res = json.loads(card)
    if set(res) != {"image_top1", "image_top3", "image_top5", "image_weighted"}:
        fail(f"step3: keys {sorted(res)}")
    print(f"step3: retrieval_results.json equal on the card and the CPU: {res} "
          f"(random weights)", flush=True)


def main_path_phase(work: Path, records: list, card: str) -> None:
    from emr2a_tpu_torch.encoders.biomedclip_encoder import BioMedCLIPEncoder
    from emr2a_tpu_torch.pipelines.step2_embeddings import build_embeddings as step2
    from emr2a_tpu_torch.utils.profiling import StageTimer

    manifest_path = step1_phase(work)
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
    t0 = time.time()
    pool = pool_phase(work, manifest_path, card)
    e2e = e2e_phase(work, image_paths, encoders, plain_cpu, int8_cpu, card)
    print(f"decode pool phases in {time.time() - t0:.1f} s", flush=True)
    step3_phase(work, work / "bf16" / "embeddings.npz", manifest_path)
    text = text_phase(encoders["int8"], plain_cpu, int8_cpu, card)
    retrieval_phase(bf16["npz"])
    db = {"launches": database_phase(work, work / "bf16" / "embeddings.npz",
                                     manifest_path)}
    run_of = {"fused_ln_mlp": bf16, "fused_ln_attention": bf16,
              "fused_ln_mlp_int8": int8, "fused_ln_attention_int8": int8,
              "linear_w8a8": text, "cosine_topk_fused": db,
              "cosine_topk_fused_int8": db}
    for rec in records:
        rec["launches"] = run_of.get(rec["name"], {"launches": {rec["name"]: 0}})[
            "launches"][rec["name"]]
    batched = p50_phase(card)
    mesh = mesh_phase(work, manifest_path, work / "bf16" / "embeddings.npz", card)
    processes = processes_phase(work, card)
    for rec in records:
        if rec["name"] in ("cosine_topk_fused", "cosine_topk_fused_int8"):
            rec["launches_by_path"] = {
                "database_cli": rec["launches"],
                **{f"database batched {d}": c[rec["name"]] for d, c in batched.items()
                   if c[rec["name"]]},
                "mesh database": mesh["mesh database"][rec["name"]],
                **{f"processes {d}": c[rec["name"]] for d, c in processes.items()
                   if c[rec["name"]]}}
            rec["launches"] = sum(rec["launches_by_path"].values())
    cv_phase(work, bf16["npz"], manifest_path, encoders["int8"], card)
    throughput_phase(encoders, card)
    del encoders, plain_cpu, int8_cpu
    t0 = time.time()
    zoo = {**vit_zoo_phase(work, manifest_path, card), **clip_zoo_phase(image_paths, card),
           **dino_zoo_phase(work, manifest_path, card)}
    torch.cuda.empty_cache()
    print(f"encoder zoo phases in {time.time() - t0:.1f} s", flush=True)
    stages = StageTimer()
    judge = judge_phase(work, manifest_path, card, stages)
    runs = judge["runs"]
    paths = {"text": text["launches"],
             **{"judge " + tag: r["launches"] for tag, r in runs.items()},
             "judge int4 sampled": judge["sampled"], "step4_int4": judge["step4"],
             "review_int4": judge["review"], **judge["serving"]["counts"],
             **judge["spec"]["counts"], **judge["vlm_direct"]["counts"]}
    for rec in records:
        name = rec["name"]
        if name in ("linear_w8a8", "linear_w4a8", "frame_flash_attention", "fused_attention"):
            rec["launches_by_path"] = {p: c[name] for p, c in paths.items() if c[name]}
            rec["launches"] = sum(rec["launches_by_path"].values())
    zoo_launches(records, zoo, {"step2 biomedclip bf16": bf16["launches"],
                                "step2 biomedclip int8": int8["launches"],
                                **e2e["launches"], "step2 vit --fast --data_parallel":
                                mesh["step2 vit --fast --data_parallel"]})
    for prec, r in runs.items():
        print(f"judge summary {prec}: prefill {r['prefill_ms']:.3f} ms (bound "
              f"{r['prefill_bound']['bound_ms']:.3f}), decode {r['decode_ms_per_token']:.3f} "
              f"ms/token eager, {r['graph_ms_per_token']:.3f} from the CUDA graph (bound "
              f"{r['decode_bound']['bound_ms']:.3f}; {r['decode']['launches_per_token']} "
              f"launches a token, busy {r['decode']['busy_share']:.3f}), peak "
              f"{r['peak_gib']:.2f} GiB, tree {r['tree_gib']:.2f} GiB ({card})", flush=True)
    for tag, r in judge["serving"]["rates"].items():
        print(f"serving summary {tag}: {r['cases_per_s']:.3f} cases/s, {r['tokens_per_s']:.1f} "
              f"tokens/s ({r['tokens']} tokens in {r['wall_s']:.3f} s) ({card})", flush=True)
    for tag, r in judge["vlm_direct"]["rates"].items():
        print(f"vlm_direct summary {tag}: {r['cases_per_s']:.3f} cases/s, "
              f"{r['tokens_per_s']:.1f} tokens/s ({r['tokens']} tokens in {r['wall_s']:.3f} s) "
              f"({card})", flush=True)
    r = {tag: v["end_to_end_slices_per_s"] for tag, v in e2e["rates"].items()}
    print(f"step2 e2e summary (batch_size = max_batch = {E2E_BATCH}): end to end slices/s "
          f"with the pool / without: bf16 {r['bf16 pool']:.1f} / {r['bf16 no_pool']:.1f}, "
          f"int8 {r['int8 pool']:.1f} / {r['int8 no_pool']:.1f}; double-buffered (batch_size "
          f"{2 * E2E_BATCH}) bf16 {r['bf16 pool double-buffered']:.1f}, int8 "
          f"{r['int8 pool double-buffered']:.1f}; the pool alone {pool['pool_1_thread']:.1f} "
          f"slices/s on 1 thread, {pool['pool_all_cores']:.1f} on {pool['affinity']} cores "
          f"(cpu_count {pool['cpu_count']}), per-image host path {pool['host_per_image']:.1f}, "
          f"PIL on {pool['affinity']} threads {pool['pil_threads_decode']:.1f} (decode alone) / "
          f"{pool['pil_threads_resized']:.1f} (with resize_rgb_reference) ({card})", flush=True)
    base = baselines_phase(work, manifest_path, card, stages)
    cnn, trainer = base["cnn"], base["trainer"]
    print(f"baselines summary: CNN train step {cnn['step_ms']:.3f} ms, "
          f"{cnn['images_per_s']:.1f} images/s, peak {cnn['peak_gib']:.2f} GiB; trainer step "
          f"{trainer['step_ms']:.2f} ms, peak {trainer['peak_gib']:.2f} GiB ({card})",
          flush=True)


# the zoo paths each record takes its launches from (its counter's count
# there): K1 with gelu and with quick_gelu share one counter, as do K2's
ZOO_PATHS = {
    "fused_ln_mlp": ("step2 vit --fast",),
    "fused_ln_attention": ("step2 vit --fast", "clip ViT-B/16 fast"),
    "fused_ln_mlp_int8": ("step2 vit --fast int8",),
    "fused_ln_attention_int8": ("step2 vit --fast int8",),
    "linear_w8a8": ("clip ViT-L/14-336 int8 image", "clip ViT-L/14-336 int8 text",
                    "step2 dino --fast int8"),
    "fused_ln_mlp activation=quick_gelu": ("clip ViT-B/16 fast",),
    "fused_ln_mlp_int8 activation=quick_gelu": ("clip ViT-L/14-336 int8 image",),
}


def zoo_launches(records: list, zoo: dict, biomedclip: dict) -> None:
    """Each record's launches by path, the zoo's paths added: step2's
    BioMedCLIP runs for the tower kernels, then ZOO_PATHS."""
    for rec in records:
        name = rec["name"]
        counter = name.split(" ")[0]
        by_path = dict(rec.get("launches_by_path", {}))
        if not by_path and name in ("fused_ln_mlp", "fused_ln_attention",
                                    "fused_ln_mlp_int8", "fused_ln_attention_int8"):
            by_path = {p: c[counter] for p, c in biomedclip.items() if c[counter]}
        for path in ZOO_PATHS.get(name, ()):
            if zoo[path][counter]:
                by_path[path] = zoo[path][counter]
        if by_path:
            rec["launches_by_path"] = by_path
            rec["launches"] = sum(by_path.values())
        else:
            rec.setdefault("launches", 0)


LAYER_BREAKDOWN_RUNS = (
    # (flags, the kernels each step call launches once, the record that
    # takes its launches from the run and the counter it reads)
    (["--what", "tune", "--merge_batch"], ("fused_ln_attention_merged", "fused_ln_mlp"),
     ("fused_ln_attention_merged", "fused_ln_attention_merged")),
    (["--what", "tune"], ("fused_ln_attention", "fused_ln_mlp"), None),
    (["--what", "tune", "--act_bf16"], ("fused_ln_attention", "fused_ln_mlp"),
     ("fused_ln_mlp act_dtype=bf16", "fused_ln_mlp")),
    (["--what", "int8block", "--act_bf16"], ("fused_ln_attention_int8", "fused_ln_mlp_int8"),
     ("fused_ln_mlp_int8 act_dtype=bf16", "fused_ln_mlp_int8")),
)


def layer_breakdown_phase(records: list, card: str) -> None:
    """The layer-breakdown entry point in-process at B = 96: each run's
    launch counts, read just after it, equal its step calls for its kernels
    and 0 for every other; the records of K3m and the act_dtype=bf16
    variants take their launches from these runs."""
    from emr2a_tpu_torch.tools import layer_breakdown

    by_name = {r["name"]: r for r in records}
    for flags, kernels, record in LAYER_BREAKDOWN_RUNS:
        torch.cuda.synchronize()
        reset_counts()
        results = layer_breakdown.main([*flags, "--batch", "96"])
        torch.cuda.synchronize()
        launches = read_counts()
        (tag, res), = results.items()
        check_launches(f"layer_breakdown {' '.join(flags)}", launches,
                       {k: res["calls"] for k in kernels})
        print(f"layer_breakdown {' '.join(flags)} --batch 96: {tag} {res['ms']:.4f} "
              f"ms/iter ({res['calls']} step calls, CUDA events, least of "
              f"{layer_breakdown.REPEATS} chains of 20; launches {launches}; {card})",
              flush=True)
        if record:
            name, counter = record
            by_name[name]["launches"] = launches[counter]
            by_name[name]["layer_breakdown_ms_per_iter"] = res["ms"]


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
    log = lib.with_suffix(".log").read_text()
    print(ptxas_summary(log), flush=True)
    print(core_occupancy(log), flush=True)

    records = kernel_phase(card) + topk_kernel_phase(card) + judge_kernel_phase(card)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        main_path_phase(Path(tmp), records, card)
    layer_breakdown_phase(records, card)

    print(card)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
