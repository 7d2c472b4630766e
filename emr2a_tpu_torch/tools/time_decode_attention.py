"""Time K10 (``ops/decode_attention``), the decoder's GQA attention over the
bf16 KV cache, on the card.

    python -m emr2a_tpu_torch.tools.time_decode_attention [--out FILE]

Shapes: the Qwen3-VL-8B judge's (32 query and 8 kv heads of 128) over a
cache of 2,240 positions (the judge cells' ``max_len``), at S = 1 with B = 8
(the batcher's 8 slots) and B = 1 (``generate``), and at S = 5 (a
speculative verify, k = 4) with B = 1 and 8; row b's mask a prompt of
2,034 - 37 b positions and a run of 101 - 11 b generated positions from
2,034 on (one more each query row). At each shape the kernel is held
against its plain version (atol = rtol = 1e-2, row cosine >= 0.9999: bf16
probabilities rounded in another order) and against itself (two calls bit
for bit), then timed: ``timings`` (median and quartiles of 100 single
launches with the wrapper's host work, the least of 3 chains of 20), 20
calls replayed in a CUDA graph on one cache (``graph_ms``, L2-warm at B = 1,
whose 9.2 MB cache fits the 50 MB L2) and cycling over caches that
together exceed the L2 (``graph_cycled_ms``, what a decode step's 36
layers see), the plain version (median of 20), and
``scaled_dot_product_attention`` with ``enable_gqa`` on the same cache as
the yardstick (``library_ms``; the port never calls it). The bound is the
cache's, the query's, the mask's and the output's bytes over 3.35 TB/s
(the operations, 4 B S H L 128, over 989 TFLOP/s bf16, are far below).
Prints one line per shape and, with ``--out``, writes the records as JSON.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

from emr2a_tpu_torch.tools.time_blocks import bound, close, nbytes
from emr2a_tpu_torch.tools.time_linears import graph_ms, timing_text, timings

H, KV, HD, L, PROMPT = 32, 8, 128, 2240, 2034
SHAPES = ((8, 1), (1, 1), (1, 5), (8, 5))       # (B, S)
L2_BYTES = 50 * 2**20


def operands(B: int, S: int, copies: int = 1, seed: int = 0):
    """q, ``copies`` (k, v) caches and the mask of a decode step at (B, S)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    rn = lambda *shape: torch.randn(*shape, generator=g, device="cuda").to(torch.bfloat16)
    q = rn(B, S, H, HD)
    caches = [(rn(B, L, KV, HD), rn(B, L, KV, HD)) for _ in range(copies)]
    # each row its own prompt and generated run, as the batcher's slots
    # hold them, so that the mask's batch stride matters
    row = torch.arange(B, device="cuda")[:, None, None]
    k_idx = torch.arange(L, device="cuda")[None, None, :]
    q_abs = PROMPT + 100 - 11 * row + torch.arange(S, device="cuda")[None, :, None]
    visible = (k_idx < PROMPT - 37 * row) | ((k_idx >= PROMPT) & (k_idx <= q_abs))
    mask = torch.where(visible, 0.0, float("-inf")).float()
    return q, caches, mask


def record(B: int, S: int, card: str) -> dict:
    from emr2a_tpu_torch.ops import decode_attention as da
    scale = HD ** -0.5
    cache_bytes = 2 * B * L * KV * HD * 2
    copies = max(2, -(-2 * L2_BYTES // cache_bytes))
    q, caches, mask = operands(B, S, copies)
    k, v = caches[0]
    fn = lambda: da.decode_attention(q, k, v, mask, scale)
    ref = lambda: da.decode_attention_reference(q, k, v, mask, scale)
    got = fn()
    torch.cuda.synchronize()
    err = close(got, ref())
    if not torch.equal(got, fn()):
        raise AssertionError(f"K10 at B = {B}, S = {S}: two calls differ")
    state = {"i": 0}

    def cycled():
        kc, vc = caches[state["i"] % copies]
        state["i"] += 1
        return da.decode_attention(q, kc, vc, mask, scale)

    rec = {"name": "decode_attention", "route": "cuda",
           "source": "emr2a_tpu_torch/csrc/decode_attention.cu",
           "replaces": "none (the JAX package's decoder einsums, XLA)",
           "shape": f"(B, S, H, KV, hd, L) = ({B}, {S}, {H}, {KV}, {HD}, {L})",
           "max_abs_err": err, "bit_identical_calls": True, **timings(fn),
           "graph_ms": graph_ms(fn), "graph_cycled_ms": graph_ms(cycled, calls=2 * copies),
           "cycled_caches": copies, "plain_ms": timings(ref, iters=20, chains=1)["ms"],
           **bound(nbytes(q, k, v, mask, got), [("bf16", 4 * B * S * H * L * HD)])}
    rec["bound_share"] = rec["bound_ms"] / rec["graph_cycled_ms"]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    mt = mask.to(torch.bfloat16)[:, None]
    lib = timings(lambda: sdpa(qt, kt, vt, attn_mask=mt, scale=scale, enable_gqa=True))
    rec.update({"library_ms": lib["ms"], "library_chained_ms": lib["chained_ms"]})
    print(f"decode_attention (K10) B = {B}, S = {S}, L = {L}: kernel {timing_text(rec)}, "
          f"CUDA graph {rec['graph_ms']:.4f} ms one cache, {rec['graph_cycled_ms']:.4f} ms "
          f"over {copies} caches; plain version {rec['plain_ms']:.4f} ms; "
          f"scaled_dot_product_attention {timing_text(lib)}; bound "
          f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}, "
          f"{100 * rec['bound_share']:.1f} % of the cycled graph time); max abs error "
          f"{err:.2e} against the plain version; two calls bit-identical ({card})",
          flush=True)
    return rec


def decode_records(card: str) -> list:
    records = [record(B, S, card) for B, S in SHAPES]
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
    records = decode_records(card)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "records": records}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
