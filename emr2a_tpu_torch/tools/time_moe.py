"""Time K11 (``ops/moe``), the routed experts of Kimi-VL's expert layers, on
the card.

    python -m emr2a_tpu_torch.tools.time_moe [--out FILE]

Shapes: the published widths (64 experts of 1,408 at hidden 2,048, top 6)
at the ``kimi-vl-a3b.audit-think`` cell's calls: a decode step of 16 slots
(96 token-expert pairs) and of one request (6 pairs), and a prefill of 16
refills of 2,510 tokens (40,160 tokens); the routing random (seeded), as
the cell's seeded routers give it. At each shape the kernel is held
against its plain version (``close``: atol = rtol = 1e-2, row cosine >=
0.9999; the SwiGLU product rounds to bf16 in another summation order),
then timed: ``timings`` (median and quartiles of 100 single launches with
the wrapper's host work, the least of 3 chains of 20) and 20 calls
replayed in a CUDA graph (``graph_ms``; the routed experts' weights, 51 x
17.3 MB at 16 slots, are far past the 50 MB L2, so each call reads them
from memory), the plain version (median of 20), and a grouped product in
plain bf16 (``torch.mm`` over each routed expert's rows, the routing
counted on the host first: the yardstick; the port never calls it). The
bound: the larger of the bytes (each routed expert's weights once, the
tokens' bf16 rows read and their f32 sums written) over 3.35 TB/s and the
operations (2 x 3 x 2,048 x 1,408 a pair) over 989 TFLOP/s bf16. Prints
one line per shape and, with ``--out``, writes the records as JSON.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

from emr2a_tpu_torch.tools.time_blocks import bound, close
from emr2a_tpu_torch.tools.time_linears import graph_ms, timing_text, timings

E, D, I, K = 64, 2048, 1408, 6
SHAPES = (("decode, 16 slots", 16), ("decode, B = 1", 1), ("prefill, 16 x 2,510", 16 * 2510))


def operands(T: int, seed: int = 0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    gu = (torch.randn(E, D, 2 * I, generator=g, device="cuda") * 0.02).to(torch.bfloat16)
    down = (torch.randn(E, I, D, generator=g, device="cuda") * 0.02).to(torch.bfloat16)
    x = torch.randn(T, D, generator=g, device="cuda").to(torch.bfloat16)
    ids = torch.topk(torch.rand(T, E, generator=g, device="cuda"), K, dim=-1).indices
    w = torch.rand(T, K, generator=g, device="cuda") + 0.1
    return x, gu, down, ids, (w / w.sum(-1, keepdim=True) * 2.446).float()


def grouped_bf16(x, gu, down, ids, w):
    """The yardstick's closure: each routed expert's rows in one bf16
    ``torch.mm`` a product, the routing read on the host beforehand."""
    flat = ids.reshape(-1)
    order = torch.sort(flat, stable=True).indices
    counts = torch.bincount(flat, minlength=E).tolist()
    rows, start = [], 0
    for e, n in enumerate(counts):
        if n:
            rows.append((e, order[start:start + n]))
        start += n
    wflat = w.reshape(-1)

    def run():
        out = torch.zeros(x.shape[0] * K, D, dtype=torch.float32, device=x.device)
        for e, pair in rows:
            h = torch.mm(x[pair // K], gu[e])
            h = torch.nn.functional.silu(h[:, :I]) * h[:, I:]
            out[pair] = torch.mm(h, down[e]).float() * wflat[pair, None]
        return out.view(-1, K, D).sum(dim=1)

    return run


def record(label: str, T: int, card: str) -> dict:
    from emr2a_tpu_torch.ops import moe
    x, gu, down, ids, w = operands(T)
    phase = "decode" if T <= 16 else "prefill"
    fn = lambda: moe.moe_experts(x, gu, down, ids, w, phase)
    got = fn()
    torch.cuda.synchronize()
    err = close(got, moe.moe_reference(x, gu, down, ids, w))
    routed = int((torch.bincount(ids.reshape(-1), minlength=E) > 0).sum())
    pairs = T * K
    rec = {"name": "moe_experts", "route": "cuda", "source": "emr2a_tpu_torch/csrc/moe.cu",
           "replaces": "none (the JAX package runs no expert layer)", "shape": label,
           "tokens": T, "pairs": pairs, "routed_experts": routed, "max_abs_err": err,
           **timings(fn, iters=100 if T <= 16 else 20), "graph_ms": graph_ms(fn),
           "plain_ms": timings(lambda: moe.moe_reference(x, gu, down, ids, w), iters=20,
                               chains=1)["ms"],
           **bound(routed * 3 * D * I * 2 + T * D * (2 + 4), [("bf16", 6 * D * I * pairs)])}
    rec["bound_share"] = rec["bound_ms"] / rec["graph_ms"]
    lib = timings(grouped_bf16(x, gu, down, ids, w), iters=20 if T <= 16 else 5)
    rec.update({"library_ms": lib["ms"], "library_chained_ms": lib["chained_ms"]})
    print(f"moe_experts (K11) {label}: {pairs} pairs over {routed} experts; kernel "
          f"{timing_text(rec)}, CUDA graph {rec['graph_ms']:.4f} ms; plain version "
          f"{rec['plain_ms']:.4f} ms; grouped bf16 torch.mm {timing_text(lib)}; bound "
          f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}, {100 * rec['bound_share']:.1f} % of "
          f"the graph time); max abs error {err:.2e} against the plain version ({card})",
          flush=True)
    return rec


def moe_records(card: str) -> list:
    """One record a shape of ``SHAPES`` (``chip_smoke.py`` carries them)."""
    records = []
    for label, T in SHAPES:
        records.append(record(label, T, card))
        torch.cuda.empty_cache()
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: the timings need the card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    records = moe_records(card)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "records": records}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
