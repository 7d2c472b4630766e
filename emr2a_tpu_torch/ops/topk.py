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
both, ``1 <= k <= K_MAX`` and ``k <= n_valid``, else ``ValueError``.
``LAUNCHES`` and ``INT8_LAUNCHES`` count the calls that went to the kernel.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from emr2a_tpu_torch.ops import _build
from emr2a_tpu_torch.ops.mlp import check_cuda_tensor
from emr2a_tpu_torch.ops.quant import s8_matmul
from emr2a_tpu_torch.ops.similarity import l2_normalize_rows

NEG_INF = -3.4e38   # the mask value of emr2a_tpu/ops/topk.py
K_MAX = 64          # TOPK_KMAX in csrc/topk.cu
DIM_MAX = 1024      # TOPK_DIM_MAX
ROWS_MIN = 256      # fewest rows a chunk of the scan is given

LAUNCHES = 0
INT8_LAUNCHES = 0


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


def cosine_topk_fused_reference(queries: torch.Tensor, database: torch.Tensor,
                                k: int, n_valid: Optional[int] = None):
    """Plain PyTorch version of K6: queries cast to the storage type, f32
    products and sums, rows >= n_valid masked, stable top-k."""
    n_valid = database.shape[0] if n_valid is None else n_valid
    scores = torch.matmul(queries.to(database.dtype).float(),
                          database.float().T)
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
    if not 1 <= k <= K_MAX:
        raise ValueError(f"k must be in [1, {K_MAX}], got {k}")
    if k > n_valid:
        raise ValueError(f"k={k} exceeds the {n_valid} valid rows")
    return n_valid


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch(queries, database, db_scales, dtype_code, k, n_valid):
    nq, dim = queries.shape
    if dim % 8 or dim > DIM_MAX:
        raise ValueError(f"the kernel needs dim divisible by 8 and at most "
                         f"{DIM_MAX}, got {dim}")
    dev = database.device
    # two chunks per SM fill the card at q = 1; every chunk gets ROWS_MIN rows
    chunks = max(1, min(2 * _sm_count(dev.index or 0), -(-n_valid // ROWS_MIN)))
    rows_per_chunk = -(-n_valid // chunks)
    cand_val = torch.empty((chunks, nq, k), dtype=torch.float32, device=dev)
    cand_idx = torch.empty((chunks, nq, k), dtype=torch.int32, device=dev)
    out_val = torch.empty((nq, k), dtype=torch.float32, device=dev)
    out_idx = torch.empty((nq, k), dtype=torch.int32, device=dev)

    import ctypes
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = _build.kernel_function("emr2a_cosine_topk", [p, p, p] + [i] * 7
                                + [p] * 5)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(queries.data_ptr(), database.data_ptr(),
                 None if db_scales is None else db_scales.data_ptr(),
                 dtype_code, nq, n_valid, dim, k, chunks, rows_per_chunk,
                 cand_val.data_ptr(), cand_idx.data_ptr(), out_val.data_ptr(),
                 out_idx.data_ptr(), stream)
    _build.check(err, "cosine_topk_fused")
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
