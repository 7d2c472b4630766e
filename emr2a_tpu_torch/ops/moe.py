"""The routed experts of a mixture-of-experts layer (K11), hand-written in
CUDA for Hopper (``csrc/moe.cu``).

K11 replaces no TPU kernel: the JAX package runs no expert layer. It was
added for Kimi-VL's decoder (``models/kimi_vl.py``): 64 SwiGLU experts of
width 1,408 at hidden 2,048, each token routed to 6. ``moe_experts(x,
w_gate_up, w_down, ids, weights)`` returns, in f32, each token's
``sum_k weights[t, k] * E_ids[t, k](x[t])`` with ``E_e(x) = (silu(x Wg_e)
* (x Wu_e)) Wd_e``; the shared experts and the router stay with the
caller.

What bounds it: in decode a step routes 16 slots x 6 = 96 token-expert
pairs, about 1.5 a routed expert, so each expert's 17.3 MB of weights
carries a few operations a byte: it is bound by the bytes of the experts
that are routed, and its design reads each routed expert's weights once
per block of its pairs and never reads an unrouted one. In a prefill of
thousands of tokens an expert gets hundreds of pairs and the products are
bound by the tensor cores. The layout is the widely used fused-MoE one,
three launches from one C call:

1. ``k11_align_kernel`` (one block): counts the pairs of each expert, pads
   each expert's run to the block of ``bm`` rows, writes the pairs' ids in
   expert order with the padding marked ``P`` (the pair count), and one
   expert id a block (-1 past the last block in use). It also adds to the
   device-side tally (``tally``): the call's pairs, its non-empty experts
   and, by an atomic max, its largest load.
2. ``k11_gemm_kernel`` (gate/up): one block of ``bm`` sorted pairs against
   64 columns of its expert's gate and up kernels, the tokens' rows
   gathered from ``x`` by cp.async, mma.sync into two f32 accumulators, and
   the SwiGLU epilogue ``silu(g) * u`` rounded once to bf16 into the sorted
   rows of ``h``.
3. ``k11_gemm_kernel`` (down): those rows of ``h`` against a tile of the
   expert's down kernel, times each pair's routing weight, stored in f32 to
   the pair's own row. The caller's sum over a token's 6 rows reduces them
   without atomics, in the same order every call.

The grids are sized for the worst case from the pair count alone (each
expert's run padded by up to ``bm - 1`` rows), never from the data, and a
block whose expert id is -1 returns at once, so a decode step replays from
the batcher's CUDA graph with no host sync. ``moe_reference`` is the plain
version (each expert's pairs gathered in turn, the same rounding points),
which a CPU tensor takes; a CUDA tensor takes the kernels or the call
raises. ``LAUNCHES`` counts the calls that went to the kernels.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from emr2a_tpu_torch.ops import _build
from emr2a_tpu_torch.utils.profiling import register_tally

LAUNCHES = 0

# Tally columns, one row a phase (prefill, decode)
PHASES = ("prefill", "decode")
TALLY_COLUMNS = ("pairs", "calls", "expert_reads", "max_load")
_TALLIES: Dict[torch.device, torch.Tensor] = {}


def _read_tally(t: torch.Tensor) -> dict:
    """The tally's counters, those of a phase that had no call left out (a
    session that ran no expert layer shows none)."""
    return {f"moe.{col}.{phase}": int(v)
            for phase, row in zip(PHASES, t.tolist()) if row[1]
            for col, v in zip(TALLY_COLUMNS, row)}


def tally(device) -> torch.Tensor:
    """The device's (phase, column) int64 tally, made (and registered with
    the tracer) at the first call there, a normal tensor even under
    inference mode; the first call is eager (a prefill, or a graph's
    warm-up step), so the tensor never comes from a graph's pool."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device not in _TALLIES:
        with torch.inference_mode(False):   # zeroed later outside inference mode
            t = torch.zeros((len(PHASES), len(TALLY_COLUMNS)), dtype=torch.int64,
                            device=device)
        _TALLIES[device] = t
        register_tally(t, _read_tally)
    return _TALLIES[device]


def block_rows(pairs: int) -> int:
    """Rows a block: one m16 tile while pairs are few, as in decode (the
    weights stream past few rows), and 128 in a prefill (the tensor cores
    bound)."""
    return 16 if pairs <= 1024 else 128


def max_blocks(pairs: int, experts: int, bm: int) -> int:
    """The most blocks the padded runs can take: every expert's run padded
    by up to ``bm - 1`` rows."""
    return -(-(pairs + experts * (bm - 1)) // bm)


def _routing_order(ids: torch.Tensor, experts: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pair ids in expert order, stable; pairs a expert) of flat ``ids``."""
    order = torch.sort(ids, stable=True).indices
    counts = torch.zeros(experts, dtype=torch.int64, device=ids.device)
    counts.scatter_add_(0, ids, torch.ones_like(ids))
    return order, counts


def add_tally(t: torch.Tensor, phase: str, pairs: int, counts: torch.Tensor) -> None:
    """The plain version's tally: the same columns as ``k11_align_kernel``'s."""
    row = t[PHASES.index(phase)]
    row[0] += pairs
    row[1] += 1
    row[2] += (counts > 0).sum()
    row[3] = torch.maximum(row[3], counts.max())


def moe_reference(x: torch.Tensor, w_gate_up: torch.Tensor, w_down: torch.Tensor,
                  ids: torch.Tensor, weights: torch.Tensor,
                  phase: str = "prefill") -> torch.Tensor:
    """x (T, D); w_gate_up (E, D, 2I) (gate columns, then up); w_down (E, I,
    D); ids (T, K) the chosen experts; weights (T, K) f32 -> (T, D) f32.
    Each expert's pairs in turn: the gate and up products in f32, ``silu(g)
    * u`` rounded to x's dtype, the down product in f32 times the pair's
    weight; a token's K rows summed in f32 in k order."""
    T, D = x.shape
    E, _, I2 = w_gate_up.shape
    K = ids.shape[1]
    flat = ids.reshape(-1).to(torch.int64)
    order, counts = _routing_order(flat, E)
    add_tally(tally(x.device), phase, flat.numel(), counts)
    rows = torch.zeros((T * K, D), dtype=torch.float32, device=x.device)
    wflat = weights.reshape(-1).float()
    start = 0
    for e, n in enumerate(counts.tolist()):
        if not n:
            continue
        pair = order[start:start + n]
        start += n
        gu = x[pair // K].float() @ w_gate_up[e].float()
        h = (torch.nn.functional.silu(gu[:, :I2 // 2]) * gu[:, I2 // 2:]).to(x.dtype)
        rows[pair] = (h.float() @ w_down[e].float()) * wflat[pair, None]
    return rows.view(T, K, D).sum(dim=1)


MAX_EXPERTS = 256


def check_operands(x, w_gate_up, w_down, ids, weights) -> None:
    """Raise unless the kernels take these operands (see ``csrc/moe.cu``)."""
    if x.dim() != 2 or w_gate_up.dim() != 3 or w_down.dim() != 3 or ids.dim() != 2:
        raise ValueError(f"x (T, D), expert kernels (E, D, 2I) and (E, I, D), ids (T, top_k); "
                         f"got {tuple(x.shape)}, {tuple(w_gate_up.shape)}, "
                         f"{tuple(w_down.shape)}, {tuple(ids.shape)}")
    dev = x.device
    T, D = x.shape
    E, D2, I2 = w_gate_up.shape
    I = I2 // 2
    for name, t, dtype in (("x", x, torch.bfloat16), ("w_gate_up", w_gate_up, torch.bfloat16),
                           ("w_down", w_down, torch.bfloat16), ("ids", ids, torch.int64),
                           ("weights", weights, torch.float32)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype} for the kernel, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if D2 != D or tuple(w_down.shape) != (E, I, D):
        raise ValueError(f"expert kernels {tuple(w_gate_up.shape)} / {tuple(w_down.shape)} "
                         f"do not fit x {tuple(x.shape)}")
    if ids.shape != weights.shape or ids.shape[0] != T:
        raise ValueError(f"ids {tuple(ids.shape)} and weights {tuple(weights.shape)} must be "
                         f"({T}, top_k)")
    if E > MAX_EXPERTS or I % 64 or D % 128:
        raise ValueError(f"the kernel takes at most {MAX_EXPERTS} experts, a width that is a "
                         f"multiple of 64 and a hidden size that is a multiple of 128: E {E}, "
                         f"I {I}, D {D}")


def moe_experts(x: torch.Tensor, w_gate_up: torch.Tensor, w_down: torch.Tensor,
                ids: torch.Tensor, weights: torch.Tensor,
                phase: str = "prefill") -> torch.Tensor:
    """The routed experts' sum per token (see ``moe_reference``), in f32;
    ``phase`` names the tally's row ("prefill" or "decode")."""
    if x.device.type == "cpu":
        return moe_reference(x, w_gate_up, w_down, ids, weights, phase)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    check_operands(x, w_gate_up, w_down, ids, weights)
    T, D = x.shape
    E, _, I2 = w_gate_up.shape
    I, K = I2 // 2, ids.shape[1]
    P = T * K
    dev = x.device
    bm = block_rows(P)
    nb = max_blocks(P, E, bm)
    sorted_ids = torch.empty((nb * bm,), dtype=torch.int32, device=dev)
    block_expert = torch.empty((nb,), dtype=torch.int32, device=dev)
    h = torch.empty((nb * bm, I), dtype=torch.bfloat16, device=dev)
    rows = torch.empty((P, D), dtype=torch.float32, device=dev)
    t = tally(dev)[PHASES.index(phase)]
    import ctypes
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = _build.kernel_function("emr2a_moe_experts", [p] * 10 + [i] * 7 + [p])
    with torch.cuda.device(dev):
        err = fn(x.data_ptr(), w_gate_up.data_ptr(), w_down.data_ptr(), ids.data_ptr(),
                 weights.data_ptr(), sorted_ids.data_ptr(), block_expert.data_ptr(),
                 h.data_ptr(), rows.data_ptr(), t.data_ptr(), T, D, I, E, K, bm, nb,
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "emr2a_moe_experts")
    global LAUNCHES
    LAUNCHES += 1
    return rows.view(T, K, D).sum(dim=1)
