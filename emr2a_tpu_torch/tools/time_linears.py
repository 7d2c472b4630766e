"""Time the two quantized linears on the card: K5 (``linear_w8a8``) and K7
(``linear_w4a8``).

    python -m emr2a_tpu_torch.tools.time_linears [--kernels k5,k7] [--out FILE]

Shapes: the Qwen3-VL-8B judge's four decoder projections (4096->4096,
4096->1024, 4096->12288, 12288->4096) at T = 1 (a decode step) and T = 2,048
(the padded prompt), and for K5 also PubMedBERT's (T = 8,192 = 32 texts x
256 tokens: 768->768, 768->3072, 3072->768). At each shape the kernel is
held bit for bit against its plain version on seeded inputs, then timed
with ``timings`` (median and quartiles of 100 single launches, each with
the wrapper's host work, and the least of 3 chains of 20 back-to-back
launches), beside a bf16 matmul on the dequantized weight (cuBLAS, timed
the same way), the plain version (median), for K5 at T > 16 the plain
version on ``torch._int_mm`` and that product alone, and the bound (the
larger of the bytes over 3.35 TB/s and the s8 operations over 1,979
TOP/s); and the time of a call with no host work, 20 calls replayed in a
CUDA graph (a chain of short calls that the host cannot keep ahead of
times the host). Prints one line per shape and, with ``--out``, writes the records
as JSON. Needs the card; uses only the wrappers' public functions.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
JUDGE = ((4096, 4096), (4096, 1024), (4096, 12288), (12288, 4096))
PUBMEDBERT = ((8192, 768, 768), (8192, 768, 3072), (8192, 3072, 768))


def shapes_of(kernel: str) -> list:
    judge = [(T, K, N) for T in (1, 2048) for K, N in JUDGE]
    return judge + list(PUBMEDBERT) if kernel == "k5" else judge


def bound(nbytes: float, ops: float) -> dict:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def timings(fn, iters: int = 100, warmup: int = 5, chain: int = 20,
            chains: int = 3) -> dict:
    """The median and quartiles of ``iters`` launches, each timed alone
    between two CUDA events, and the least of ``chains`` chains of
    ``chain`` back-to-back launches, per launch."""
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
    chained = []
    for _ in range(chains):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(chain):
            fn()
        end.record()
        end.synchronize()
        chained.append(start.elapsed_time(end) / chain)
    q1, med, q3 = (float(x) for x in np.percentile(times, [25, 50, 75]))
    return {"ms": med, "ms_q1": q1, "ms_q3": q3, "chained_ms": min(chained)}


def graph_ms(fn, calls: int = 20, replays: int = 3) -> float:
    """The device time of one call of ``fn`` with no host work: ``calls``
    calls captured in one CUDA graph, replayed between two CUDA events; the
    least of ``replays`` replays, per call."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / calls)
    del graph
    return best


def timing_text(t: dict) -> str:
    return (f"{t['ms']:.4f} ms (quartiles {t['ms_q1']:.4f}-{t['ms_q3']:.4f}; "
            f"chained {t['chained_ms']:.4f})")


def _operands(kernel: str, T: int, K: int, N: int, seed: int):
    """Seeded x (T, K) bf16, the quantized weight, its scales, a bf16 bias
    and the dequantized bf16 weight (K, N)."""
    from emr2a_tpu_torch.models.quantize import quantize_weight_int8_torch
    from emr2a_tpu_torch.ops import linear_int4

    g = torch.Generator(device="cuda").manual_seed(seed)
    rn = lambda *s, std=1.0: (torch.randn(*s, generator=g, device="cuda") * std).to(
        torch.bfloat16)
    x = rn(T, K)
    w = rn(K, N, std=0.02).float()
    bias = rn(N, std=0.02)
    if kernel == "k5":
        wq, ws = quantize_weight_int8_torch(w)
        ws = ws.reshape(-1)
        w_deq = (wq.float() * ws).to(torch.bfloat16)
    else:
        wq, ws = linear_int4.quantize_weight_int4_torch(w)
        w_deq = (linear_int4.unpack_int4(wq, 128).float()
                 * ws.repeat_interleave(128, dim=0)).to(torch.bfloat16)
        bias = None           # the judge's int4 projections have no bias
    return x, wq, ws, bias, w_deq


def shape_record(kernel: str, T: int, K: int, N: int, seed: int = 0) -> dict:
    """One shape: bit-identity, then the kernel's, the yardsticks' and the
    plain version's times, and the bound."""
    from emr2a_tpu_torch.ops import linear_int4, linear_int8, quant

    x, wq, ws, bias, w_deq = _operands(kernel, T, K, N, seed + T + K + N)
    if kernel == "k5":
        fn = lambda: linear_int8.linear_w8a8(x, wq, ws, bias)
        ref = lambda: linear_int8.linear_w8a8_reference(x, wq, ws, bias)
    else:
        fn = lambda: linear_int4.linear_w4a8(x, wq, ws, bias)
        ref = lambda: linear_int4.linear_w4a8_reference(x, wq, ws, bias)
    got = fn()
    torch.cuda.synchronize()
    want = ref()
    tag = f"{'linear_w8a8' if kernel == 'k5' else 'linear_w4a8'} T={T} {K}->{N}"
    if not torch.equal(got, want):
        raise AssertionError(f"{tag}: not bit-identical to its plain version "
                             f"({(got.float() - want.float()).abs().max().item()})")
    nbytes = sum(t.numel() * t.element_size() for t in (x, wq, ws, bias)
                 if t is not None) + T * N * 2
    rec = {"shape": f"T={T}, {K}->{N}", "T": T, "K": K, "N": N,
           "bit_identical": True, "max_abs_err": 0.0, **timings(fn),
           **bound(nbytes, 2 * T * K * N), "library_ms": None}
    rec["graph_ms"] = graph_ms(fn)
    rec["bound_share_chained"] = rec["bound_ms"] / rec["chained_ms"]
    rec["bound_share_graph"] = rec["bound_ms"] / rec["graph_ms"]
    mm = timings(lambda: x @ w_deq)
    rec["bf16_matmul_ms"], rec["bf16_matmul_chained_ms"] = mm["ms"], mm["chained_ms"]
    rec["bf16_matmul_graph_ms"] = graph_ms(lambda: x @ w_deq)
    plain_iters = 100 if T <= 16 else 5
    rec["plain_ms"] = timings(ref, iters=plain_iters, warmup=1, chain=1, chains=1)["ms"]
    if kernel == "k5" and T > 16:     # torch._int_mm needs more than 16 rows
        xq, xs = quant.quantize_rows_s8_reference(x)
        w_cm = wq.t().contiguous().t()

        def int_mm_plain():
            y = torch._int_mm(xq, w_cm).float() * xs * ws
            return (y + bias.float()).to(torch.bfloat16)
        if not torch.equal(int_mm_plain(), want):
            raise AssertionError(f"{tag}: the int_mm yardstick differs")
        rec["int_mm_ms"] = timings(int_mm_plain)["ms"]
        rec["int_mm_product_ms"] = timings(lambda: torch._int_mm(xq, w_cm))["ms"]
    print(f"{tag}: bit-identical; kernel {timing_text(rec)}, in a CUDA graph "
          f"{rec['graph_ms']:.4f}; bf16 matmul {timing_text(mm)}, in a CUDA graph "
          f"{rec['bf16_matmul_graph_ms']:.4f}; plain {rec['plain_ms']:.4f}"
          + (f", int_mm plain {rec['int_mm_ms']:.4f}, int_mm product "
             f"{rec['int_mm_product_ms']:.4f}" if "int_mm_ms" in rec else "")
          + f", bound {rec['bound_ms']:.4f} ({rec['bound_by']}; share of chained "
          f"{100 * rec['bound_share_chained']:.1f} %, of graph "
          f"{100 * rec['bound_share_graph']:.1f} %)", flush=True)
    del x, wq, ws, bias, w_deq
    return rec


def linear_records(kernels=("k5", "k7")) -> dict:
    return {k: [shape_record(k, *s) for s in shapes_of(k)] for k in kernels}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels", default="k5,k7")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: the timings need the card", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    records = linear_records(tuple(args.kernels.split(",")))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "records": records}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
