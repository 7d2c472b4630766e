"""Cosine similarity + top-k retrieval: the plain path and the fused scan
(K6), hand-written for Hopper.

Port of ``emr2a_tpu/ops/topk.py``. ``topk_scores`` and ``cosine_topk`` are
its XLA paths: a full score matmul, then the top-k. Ties go to the lowest
index, as ``jax.lax.top_k`` gives them: ``torch.topk`` promises no order
among equal scores, so the selection is a stable descending sort.

``cosine_topk_fused`` is the counterpart of ``cosine_topk_pallas`` (K6):
one streaming pass over a pre-normalised database in its storage type (f32
or bf16; the queries are cast to it), f32 scores, rows ``>= n_valid``
masked to ``NEG_INF``, top-k descending with ties to the lowest index.
``cosine_topk_fused_int8`` computes the int8 scan of
``emr2a_tpu/retrieval/database.py:49-60,71-73``, which the JAX package
leaves to XLA: each f32 query row is quantized (``max|q| / 127``, a zero
row scaled by 1, ``rint``, clip), the dot products with the row codes are
exact s32 sums, and the score is ``f32(s32) * q_scale * db_scale``, two
rounded multiplies in that order. It gets a kernel on the card because it
has no other route there: ``torch.matmul`` takes no s8 operands on CUDA and
``torch._int_mm`` refuses a single query.

A CPU tensor goes to the ``*_reference`` plain version; a CUDA tensor goes
to ``csrc/topk.cu`` (dim % 8 == 0, dim <= 1024), or the call raises. On
both, any ``1 <= k <= n_valid``, else ``ValueError``, as the JAX scans take
any k.

K6 has two scans on the card, both hand-written: the streaming scan (the
queries in registers, one warp-reduced dot product per row; k at most
``SCAN_K_MAX``) and the tile scan (a tile of up to 64 queries in shared
memory, DB tiles through a cp.async ring, scores by mma.sync for bf16 and
s8, register-tiled FFMA for f32; any k). The wrapper takes the tile scan
from ``TILE_MIN_Q[storage]`` queries on, or for ``k > SCAN_K_MAX``. The
crossover, measured by ``chip_smoke.py`` at 1M x 512, k = 5, q in
{1, 4, 8, 16, 32, 64} on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md,
section 6): in f32 the tile scan is faster from q = 8 (it is bound by
FFMA, the streaming scan by bytes); in bf16 and int8 it matches the
streaming scan at q = 1 to 4 and wins from q = 8. So q = 1 keeps the
streaming scan, and the tile scan starts at q = 8 (f32) and q = 4 (bf16,
int8).
``LAUNCHES`` and ``INT8_LAUNCHES`` count the calls that went to the kernel
(either scan); ``TILE_LAUNCHES`` counts those of them that took the tile
scan.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from emr2a_tpu_torch.ops import _build
from emr2a_tpu_torch.ops.mlp import check_cuda_tensor
from emr2a_tpu_torch.ops.quant import s8_matmul
from emr2a_tpu_torch.ops.similarity import l2_normalize_rows

NEG_INF = -3.4e38   # the mask value of emr2a_tpu/ops/topk.py
SCAN_K_MAX = 64     # TOPK_KMAX in csrc/topk.cu: the streaming scan's lists
DIM_MAX = 1024      # TOPK_DIM_MAX
ROWS_MIN = 256      # fewest rows a chunk of the streaming scan is given
# queries from which the tile scan is taken, by storage type (dtype code)
TILE_MIN_Q = {0: 8, 1: 4, 2: 4}

LAUNCHES = 0
INT8_LAUNCHES = 0
TILE_LAUNCHES = 0


def topk_scores(scores: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., n) scores -> top-k (values, indices), descending, ties to the
    lowest index."""
    values, indices = torch.sort(scores, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def cosine_topk(queries: torch.Tensor, database: torch.Tensor, k: int,
                normalize: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """queries (q, dim), database (n, dim) -> values (q, k), indices (q, k),
    scores in f32."""
    queries = queries.float()
    database = database.float()
    if normalize:
        queries = l2_normalize_rows(queries)
        database = l2_normalize_rows(database)
    return topk_scores(torch.matmul(queries, database.T), k)


def _masked_topk(scores: torch.Tensor, k: int, n_valid: int):
    col = torch.arange(scores.shape[-1], device=scores.device)
    scores = torch.where(col < n_valid, scores,
                         torch.tensor(NEG_INF, device=scores.device))
    values, indices = topk_scores(scores, k)
    return values, indices.to(torch.int32)


def score_matmul(a: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """f32 scores ``a @ b_t`` of f32 operands. On the card the sums are f32;
    on the CPU they are taken in f64 and rounded once to f32, since the
    order of an f32 sum there follows the BLAS kernel that the matrix's
    width selects: a database shard's scores then equal the whole
    matrix's bit for bit."""
    if a.is_cuda:
        return a @ b_t
    return (a.double() @ b_t.double()).float()


def cosine_topk_fused_reference(queries: torch.Tensor, database: torch.Tensor,
                                k: int, n_valid: Optional[int] = None):
    """Plain PyTorch version of K6: queries cast to the storage type, f32
    products, sums as ``score_matmul`` takes them, rows >= n_valid masked,
    stable top-k."""
    n_valid = database.shape[0] if n_valid is None else n_valid
    scores = score_matmul(queries.to(database.dtype).float(), database.float().T)
    return _masked_topk(scores, k, n_valid)


def quantize_queries_int8(queries: torch.Tensor):
    """The DB scan's query quantize (``emr2a_tpu/retrieval/database.py:52-55``):
    (q, dim) f32 -> ((q, dim) int8 codes, (q,) f32 scales), scale =
    max|q| / 127 with a zero row scaled by 1, codes rint(q / scale)."""
    q = queries.float()
    amax = q.abs().amax(dim=1)
    # a true division: PyTorch's CUDA division by a Python scalar multiplies
    # by its reciprocal, which can differ in the last bit
    scale = amax / torch.full_like(amax, 127.0)
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    codes = torch.clamp(torch.round(q / scale[:, None]), -127, 127)
    return codes.to(torch.int8), scale


def cosine_topk_fused_int8_reference(queries: torch.Tensor, db_q: torch.Tensor,
                                     db_scales: torch.Tensor, k: int,
                                     n_valid: Optional[int] = None):
    """Plain PyTorch version of K6's int8 variant: exact s32 sums (in f64),
    then ``f32(acc) * q_scale * db_scale``."""
    n_valid = db_q.shape[0] if n_valid is None else n_valid
    codes, qscale = quantize_queries_int8(queries)
    scores = s8_matmul(codes, db_q.T) * qscale[:, None] * db_scales.float()[None, :]
    return _masked_topk(scores, k, n_valid)


def _check(queries, database, k, n_valid) -> int:
    if queries.dim() != 2 or database.dim() != 2:
        raise ValueError(f"queries and database must be 2-D, got "
                         f"{tuple(queries.shape)} and {tuple(database.shape)}")
    if queries.shape[1] != database.shape[1]:
        raise ValueError(f"dims differ: queries {queries.shape[1]}, "
                         f"database {database.shape[1]}")
    n = database.shape[0]
    n_valid = n if n_valid is None else int(n_valid)
    if not 0 < n_valid <= n:
        raise ValueError(f"n_valid must be in [1, {n}], got {n_valid}")
    if k < 1:
        raise ValueError(f"k must be at least 1, got {k}")
    if k > n_valid:
        raise ValueError(f"k={k} exceeds the {n_valid} valid rows")
    return n_valid


def _launch(queries, database, db_scales, dtype_code, k, n_valid):
    nq, dim = queries.shape
    if dim % 8 or dim > DIM_MAX:
        raise ValueError(f"the kernel needs dim divisible by 8 and at most "
                         f"{DIM_MAX}, got {dim}")
    dev = database.device
    sms = _build.sm_count(dev.index or 0)
    tile = nq >= TILE_MIN_Q[dtype_code] or k > SCAN_K_MAX

    import ctypes
    p, i = ctypes.c_void_p, ctypes.c_int
    if tile:
        plan = _build.kernel_function("emr2a_cosine_topk_tc_chunks", [i] * 6)
        chunks = plan(dtype_code, nq, n_valid, dim, k, sms)
        if chunks < 1:
            raise ValueError(f"the tile scan refuses nq={nq}, n_valid={n_valid}, "
                             f"dim={dim}, k={k}")
    else:
        # two chunks per SM fill the card at q = 1; every chunk gets ROWS_MIN rows
        chunks = max(1, min(2 * sms, -(-n_valid // ROWS_MIN)))
    cand_val = torch.empty((chunks, nq, k), dtype=torch.float32, device=dev)
    cand_idx = torch.empty((chunks, nq, k), dtype=torch.int32, device=dev)
    out_val = torch.empty((nq, k), dtype=torch.float32, device=dev)
    out_idx = torch.empty((nq, k), dtype=torch.int32, device=dev)
    operands = (queries.data_ptr(), database.data_ptr(),
                None if db_scales is None else db_scales.data_ptr(),
                dtype_code, nq, n_valid, dim, k)
    scratch = (cand_val.data_ptr(), cand_idx.data_ptr(), out_val.data_ptr(),
               out_idx.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    with torch.cuda.device(dev):
        if tile:
            fn = _build.kernel_function("emr2a_cosine_topk_tc", [p, p, p] + [i] * 7 + [p] * 5)
            err = fn(*operands, sms, chunks, *scratch)
        else:
            fn = _build.kernel_function("emr2a_cosine_topk", [p, p, p] + [i] * 7 + [p] * 5)
            err = fn(*operands, chunks, -(-n_valid // chunks), *scratch)
    _build.check(err, "cosine_topk_fused")
    if tile:
        global TILE_LAUNCHES
        TILE_LAUNCHES += 1
    return out_val, out_idx


def cosine_topk_fused(queries: torch.Tensor, database: torch.Tensor, k: int,
                      n_valid: Optional[int] = None):
    """queries (q, dim), pre-normalised database (n, dim) f32 or bf16 ->
    values (q, k) f32, indices (q, k) int32; rows >= n_valid (default n)
    are not candidates."""
    n_valid = _check(queries, database, k, n_valid)
    if database.device.type == "cpu":
        return cosine_topk_fused_reference(queries, database, k, n_valid)
    if database.device.type != "cuda":
        raise ValueError(f"no kernel for device {database.device}")
    if database.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the kernel scans f32 or bf16, got {database.dtype}")
    dev = database.device
    q = queries.to(device=dev, dtype=database.dtype).contiguous()
    check_cuda_tensor("queries", q, dev, database.dtype)
    check_cuda_tensor("database", database, dev, database.dtype)
    out = _launch(q, database, None, 0 if database.dtype == torch.float32 else 1,
                  k, n_valid)
    global LAUNCHES
    LAUNCHES += 1
    return out


def cosine_topk_fused_int8(queries_f32: torch.Tensor, db_q: torch.Tensor,
                           db_scales: torch.Tensor, k: int,
                           n_valid: Optional[int] = None):
    """f32 queries (q, dim), int8 row codes (n, dim) and their (n,) f32
    scales -> values (q, k) f32, indices (q, k) int32."""
    n_valid = _check(queries_f32, db_q, k, n_valid)
    if db_q.device.type == "cpu":
        return cosine_topk_fused_int8_reference(queries_f32, db_q, db_scales,
                                                k, n_valid)
    if db_q.device.type != "cuda":
        raise ValueError(f"no kernel for device {db_q.device}")
    dev = db_q.device
    q = queries_f32.to(device=dev, dtype=torch.float32).contiguous()
    check_cuda_tensor("queries", q, dev, torch.float32)
    check_cuda_tensor("db_q", db_q, dev, torch.int8)
    check_cuda_tensor("db_scales", db_scales, dev, torch.float32,
                      (db_q.shape[0],))
    out = _launch(q, db_q, db_scales, 2, k, n_valid)
    global INT8_LAUNCHES
    INT8_LAUNCHES += 1
    return out
