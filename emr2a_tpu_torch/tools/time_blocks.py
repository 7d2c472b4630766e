"""Time the tower's fused blocks on the card: K1 (``fused_ln_mlp``, also with
``act_dtype=bf16`` and with CLIP's quick_gelu), K2 (``fused_ln_mlp_int8``,
also with ``act_dtype=bf16`` and with quick_gelu at ViT-L/14-336's width),
K3 (``fused_ln_attention``), K3m (its ``merge_batch=True`` schedule,
block_b 4) and K4 (``fused_ln_attention_int8``, also at ViT-L/14-336's
width).

    python -m emr2a_tpu_torch.tools.time_blocks [--kernels k2,k4] [--out FILE]

Shapes: the main path's, at BioMedCLIP ViT-B/16 width (d = 768, m = 3,072,
12 heads of 64, valid_len 197): step2's device batch of 32 slices at S =
200 (K1 and K2 at T = 6,400), the layer breakdown's B = 96 x 200 (T =
19,200) and the tower's throughput batch of 128 at S = 197 (T = 25,216);
K1's and K2's bf16 gelu at the first two, K2 at the first and the
last; K1 with quick_gelu (CLIP ViT-B/16) at the first; K2 with quick_gelu
and K4 at CLIP ViT-L/14-336's width (d = 1,024, m = 4,096, 16 heads,
valid_len 577) at a batch of 8 images padded to S = 584 (``k2_quick_gelu``,
``k4_clip_l``). At each shape the kernel is held against its plain version (atol =
rtol = 1e-2 and row cosine >= 0.9999 on the valid rows; K3m bit for bit
against K3), then timed with ``time_linears.timings`` (median and
quartiles of 100 single launches, each with the wrapper's host work, and
the least of 3 chains of 20) and ``time_linears.graph_ms`` (one call's
device time, 20 calls replayed in a CUDA graph), beside a yardstick timed
the same way: plain bf16 PyTorch on the same inputs (cuBLAS products,
``layer_norm``, ``softmax``) for K1, K3 and K3m, and the plain version
with its s8 products on ``torch._int_mm`` for K2 and K4; the device time
of one call by kernel (``torch.profiler``); the plain version's median at
the first shape; the bound (the larger of the bytes over 3.35 TB/s and
the operations over the dense peak of their type; for K2 also the byte
floor of its f32 h1 and q2 round trips); and the SHA-256 of the output's
bytes, so that two trees' outputs on the same seeded inputs can be
compared. K3m's records also carry its group, its number of groups and
its device launches a call. ``--k3m_variants`` also times K3m's schedule
variants (its group from the rule, ``block_b``, or the least that covers
the SMs once, twice or three times, on one stream or two) against K3 at every shape, bit for bit against K3, in
turns. Prints one line per shape and, with ``--out``, writes the records
as JSON. Uses only the wrappers' public functions (K3m's group where the
tree has its rule), so the same file times an older tree of the port.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys

import torch

from emr2a_tpu_torch.tools.time_linears import graph_ms, timing_text, timings

# H100 SXM peaks (NVIDIA's data sheet, dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
D, M, H, VALID = 768, 3072, 12, 197
# (B, S) of step2's device batch, the layer breakdown and the tower's batch
SHAPES = ((32, 200), (96, 200), (128, 197))
BLOCK_B = 4
# (d, m, heads, valid_len) of each width, and the (B, S) timed there
WIDTHS = {"vit_b": ((D, M, H, VALID), SHAPES),
          "clip_l": ((1024, 4096, 16, 577), ((8, 584),))}
# the kernels timed at CLIP ViT-L/14-336's width; the rest at ViT-B's
CLIP_L_KERNELS = ("k2_quick_gelu", "k4_clip_l")


def bound(nbytes: float, ops=()) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the peak of their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = sum(n / PEAK_OPS_PER_S[kind] for kind, n in ops)
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def close(got: torch.Tensor, want: torch.Tensor) -> float:
    """atol = rtol = 1e-2 and row cosine >= 0.9999; returns the max abs
    error (raises AssertionError otherwise)."""
    got = got.float().reshape(-1, got.shape[-1])
    want = want.float().reshape(-1, want.shape[-1])
    if not torch.isfinite(got).all():
        raise AssertionError("non-finite output")
    torch.testing.assert_close(got, want, atol=1e-2, rtol=1e-2)
    cos = torch.nn.functional.cosine_similarity(got, want, dim=-1).min().item()
    if cos < 0.9999:
        raise AssertionError(f"min row cosine {cos} < 0.9999")
    return (got - want).abs().max().item()


def operands(seed: int = 0, width: str = "vit_b") -> dict:
    """Seeded bf16 block weights at ``width`` (ViT-B by default), their W8A8
    codes (quantized on the card, as ``fast="int8"`` does) and one (B, S,
    d) input per shape timed there."""
    from emr2a_tpu_torch.models.quantize import quantize_weight_int8_torch

    (d, m, heads, valid), shapes = WIDTHS[width]
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rn(*shape, std=1.0):
        return (torch.randn(*shape, generator=g, device="cuda") * std).to(torch.bfloat16)

    ln = ((1.0 + rn(d, std=0.1).float()).to(torch.bfloat16), rn(d, std=0.1))
    mlp_w = (rn(d, m, std=0.02), rn(m, std=0.02), rn(m, d, std=0.02), rn(d, std=0.02))
    attn_w = [rn(d, d, std=0.02) if i % 2 == 0 else rn(d, std=0.02) for i in range(8)]
    attn_q, mlp_q = [], []
    for i in (0, 2, 4, 6):
        q, s = quantize_weight_int8_torch(attn_w[i])
        attn_q += [q, s.reshape(-1), attn_w[i + 1]]
    for i in (0, 2):
        q, s = quantize_weight_int8_torch(mlp_w[i])
        mlp_q += [q, s.reshape(-1), mlp_w[i + 1]]
    xs = {shape: rn(*shape, d) for shape in shapes}
    return {"ln": ln, "mlp": mlp_w, "mlp_q": mlp_q, "attn": attn_w, "attn_q": attn_q,
            "x": xs, "dims": (d, m, heads, valid)}


def plain_bf16_mlp(x2, ln, w, activation: str = "gelu"):
    """The block in plain bf16 PyTorch (cuBLAS products), a yardstick."""
    from emr2a_tpu_torch.ops.mlp import _kernel_activation
    w1, b1, w2, b2 = w
    h = torch.nn.functional.layer_norm(x2, (x2.shape[-1],), ln[0], ln[1], 1e-6)
    return x2 + (_kernel_activation(activation)(h @ w1 + b1) @ w2 + b2)


def plain_bf16_attention(x, ln, w, heads: int, valid_len: int):
    """The block in plain bf16 PyTorch (cuBLAS products, softmax), a
    yardstick."""
    B, S, d = x.shape
    h = torch.nn.functional.layer_norm(x, (d,), ln[0], ln[1], 1e-6)
    q, k, v = (h @ w[i] + w[i + 1] for i in (0, 2, 4))
    split = lambda t: t.reshape(B, S, heads, d // heads).transpose(1, 2)
    mask = torch.zeros(S, device=x.device, dtype=x.dtype)
    mask[valid_len:] = float("-inf")
    o = torch.softmax(split(q) @ split(k).transpose(-1, -2) * (d // heads) ** -0.5
                      + mask, dim=-1) @ split(v)
    return x + o.transpose(1, 2).reshape(B, S, d) @ w[6] + w[7]


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


def device_breakdown(fn, calls: int = 20) -> dict:
    """Device ms a call of ``fn``, by kernel: ``torch.profiler`` over
    ``calls`` calls after a warm-up; kernel names cut at their arguments."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = e.cuda_time_total
        if us > 0:
            name = e.key.split("(")[0].replace("void ", "")
            out[name] = out.get(name, 0.0) + us / 1e3 / calls
    return out


def digest(t: torch.Tensor) -> str:
    """SHA-256 of a tensor's bytes (bf16 read as int16)."""
    raw = t.contiguous().view(torch.int16) if t.dtype == torch.bfloat16 else t.contiguous()
    return hashlib.sha256(raw.cpu().numpy().tobytes()).hexdigest()


def _timed(fn) -> dict:
    t = timings(fn)
    t["graph_ms"] = graph_ms(fn)
    return t


def block_record(kernel: str, shape, ops: dict, plain: bool) -> dict:
    """One kernel at one (B, S): the check against its plain version, its
    times, the yardstick's and the bound. ``plain`` also times the plain
    version (slow: f32 products on the card)."""
    from emr2a_tpu_torch.ops import attention_block, mlp

    B, S = shape
    D, M, H, VALID = ops["dims"]
    x = ops["x"][shape]
    ln, mw, aw, aq = ops["ln"], ops["mlp"], ops["attn"], ops["attn_q"]
    x2 = x.reshape(B * S, D)
    rows = slice(None)
    extra = {}
    activation = "quick_gelu" if kernel.endswith("quick_gelu") else "gelu"
    if kernel.startswith("k2"):
        act = torch.bfloat16 if kernel == "k2_bf16_gelu" else torch.float32
        mq = ops["mlp_q"]
        fn = lambda: mlp.fused_ln_mlp_int8(x2, *ln, *mq, activation=activation, act_dtype=act)
        ref = lambda: mlp.fused_ln_mlp_int8_reference(x2, *ln, *mq, activation=activation,
                                                      act_dtype=act)
        yard = int_mm_version(mlp, ref, mq[0::3])
        bnd = bound(nbytes(x2, *ln, *mq) + nbytes(x2), [("int8", 4 * B * S * D * M)])
        # f32 h1 written and read back, its codes q2 written and read back
        extra["h1_floor_ms"] = B * S * M * (2 * 4 + 2) / HBM_BYTES_PER_S * 1e3
        tag = f"T={B * S}, {D}->{M}->{D}"
    elif kernel.startswith("k1"):
        act = torch.bfloat16 if kernel == "k1_bf16_gelu" else torch.float32
        fn = lambda: mlp.fused_ln_mlp(x2, *ln, *mw, activation=activation, act_dtype=act)
        ref = lambda: mlp.fused_ln_mlp_reference(x2, *ln, *mw, activation=activation,
                                                 act_dtype=act)
        yard = lambda: plain_bf16_mlp(x2, ln, mw, activation)
        bnd = bound(nbytes(x2, *ln, *mw) + nbytes(x2), [("bf16", 4 * B * S * D * M)])
        tag = f"T={B * S}, {D}->{M}->{D}"
    else:
        attn_ops = 4 * B * H * S * VALID * (D // H)
        rows = slice(0, VALID)
        if kernel.startswith("k4"):
            fn = lambda: attention_block.fused_ln_attention_int8(
                x, *ln, *aq, num_heads=H, valid_len=VALID)
            ref = lambda: attention_block.fused_ln_attention_int8_reference(
                x, *ln, *aq, num_heads=H, valid_len=VALID)
            yard = int_mm_version(attention_block, ref, aq[0::3])
            bnd = bound(nbytes(x, *ln, *aq) + nbytes(x),
                        [("int8", 8 * B * S * D * D), ("bf16", attn_ops)])
        else:
            merged = {"block_b": BLOCK_B, "merge_batch": True} if kernel == "k3m" else {}
            fn = lambda: attention_block.fused_ln_attention(
                x, *ln, *aw, num_heads=H, valid_len=VALID, **merged)
            if kernel == "k3m":
                ref = lambda: attention_block.fused_ln_attention_merged_reference(
                    x, *ln, *aw, num_heads=H, valid_len=VALID, block_b=BLOCK_B)
            else:
                ref = lambda: attention_block.fused_ln_attention_reference(
                    x, *ln, *aw, num_heads=H, valid_len=VALID)
            yard = lambda: plain_bf16_attention(x, ln, aw, H, VALID)
            bnd = bound(nbytes(x, *ln, *aw) + nbytes(x), [("bf16", 8 * B * S * D * D + attn_ops)])
        tag = f"({B}, {S}, {D}), valid_len {VALID}" + (
            f", block_b {BLOCK_B}" if kernel == "k3m" else "")
    got = fn()
    torch.cuda.synchronize()
    rec = {"kernel": kernel, "shape": tag,
           "max_abs_err": close(got.reshape(B, S, D)[:, rows],
                                ref().reshape(B, S, D)[:, rows]),
           "out_sha256": digest(got), **extra}
    if kernel == "k3m":
        k3 = attention_block.fused_ln_attention(x, *ln, *aw, num_heads=H, valid_len=VALID)
        if not torch.equal(got, k3):
            raise AssertionError(f"k3m {tag}: not bit-identical to K3")
        rec["bit_identical_to_k3"] = True
        if hasattr(attention_block, "merged_group"):   # an older tree has no rule
            rec.update(k3m_schedule(B, S))
            tag += f", group {rec['group']} x {rec['groups']}"
    del got
    rec.update(_timed(fn))
    y = _timed(yard)
    rec.update({"yardstick": "int_mm plain" if kernel[:2] in ("k2", "k4")
                else "plain bf16",
                "yardstick_ms": y["ms"], "yardstick_chained_ms": y["chained_ms"],
                "yardstick_graph_ms": y["graph_ms"], **bnd, "library_ms": None,
                "plain_ms": timings(ref, iters=5, warmup=1, chain=1, chains=1)["ms"]
                if plain else None})
    rec["device_ms_by_kernel"] = device_breakdown(fn)
    rec["bound_share_chained"] = rec["bound_ms"] / rec["chained_ms"]
    rec["bound_share_graph"] = rec["bound_ms"] / rec["graph_ms"]
    print(f"{kernel} {tag}: max_abs_err {rec['max_abs_err']:.4g}; kernel {timing_text(rec)}, "
          f"in a CUDA graph {rec['graph_ms']:.4f}; {rec['yardstick']} {timing_text(y)}, in a "
          f"CUDA graph {y['graph_ms']:.4f}"
          + (f"; plain {rec['plain_ms']:.4f}" if plain else "")
          + f"; bound {rec['bound_ms']:.4f} ({rec['bound_by']}; share of chained "
          f"{100 * rec['bound_share_chained']:.1f} %, of graph "
          f"{100 * rec['bound_share_graph']:.1f} %)"
          + (f"; h1 + q2 byte floor {extra['h1_floor_ms']:.4f}" if extra else "")
          + "; device ms a call by kernel: " + ", ".join(
              f"{k} {v:.4f}" for k, v in rec["device_ms_by_kernel"].items())
          + f"; output sha256 {rec['out_sha256'][:16]}", flush=True)
    return rec


def k3m_schedule(B: int, S: int) -> dict:
    """K3m's group at (B, S) on this card (``merged_group``), its number
    of groups and its device launches a call (4 a group: LN, Q/K/V, the
    attention core, the out-projection)."""
    from emr2a_tpu_torch.ops import attention_block
    G = attention_block.merged_group(B, S, D, BLOCK_B, *attention_block.device_caps(
        torch.cuda.current_device()))
    groups = -(-B // G)
    return {"group": G, "groups": groups, "device_launches_per_call": 4 * groups,
            "streams": 2 if groups > 1 else 1}


# K3m's schedules timed against each other (--k3m_variants): (name, the
# group: the rule's (None), block_b's, or the least covering the SMs that
# many times with no L2 limit; streams)
K3M_VARIANTS = (
    ("rule group, 2 streams", None, 2),
    ("rule group, 1 stream", None, 1),
    ("block_b group, 2 streams", "block_b", 2),
    ("block_b group, 1 stream", "block_b", 1),
    ("one-wave group, 2 streams", 1.0, 2),
    ("two-wave group, 2 streams", 2.0, 2),
    ("three-wave group, 2 streams", 3.0, 2),
)


def _variant_group(rule, spec, B: int, S: int, caps) -> int:
    if spec == "block_b":
        return min(BLOCK_B, B)
    kw = {} if spec is None else {"waves": spec, "l2_share": 1.0}
    return rule(B, S, D, BLOCK_B, *caps, **kw)


def k3m_variants(ops: dict, rounds: int = 2) -> list:
    """K3m's schedule variants at every shape of SHAPES, each bit for bit
    against K3, chained and CUDA-graph ms a call, in ``rounds`` turns
    (variant order reversed every other turn); K3 in the same turns."""
    from emr2a_tpu_torch.ops import attention_block

    ln, aw = ops["ln"], ops["attn"]
    rule, side = attention_block.merged_group, attention_block._side_stream
    out = []
    try:
        for B, S in SHAPES:
            x = ops["x"][(B, S)]
            k3 = lambda: attention_block.fused_ln_attention(
                x, *ln, *aw, num_heads=H, valid_len=VALID)
            want = k3()
            caps = attention_block.device_caps(torch.cuda.current_device())
            runs = [("K3", None, None)] + list(K3M_VARIANTS)
            times = {name: [] for name, *_ in runs}
            for r in range(rounds):
                for name, spec, n_streams in (runs if r % 2 == 0 else runs[::-1]):
                    if n_streams is None:
                        fn = k3
                    else:
                        g = _variant_group(rule, spec, B, S, caps)
                        attention_block.merged_group = lambda *a, g=g, **kw: g
                        if n_streams == 1:   # every group on the current stream
                            attention_block._side_stream = lambda current: current
                        fn = lambda: attention_block.fused_ln_attention(
                            x, *ln, *aw, num_heads=H, valid_len=VALID, block_b=BLOCK_B,
                            merge_batch=True)
                        if not torch.equal(fn(), want):
                            raise AssertionError(f"k3m {name} at {(B, S)}: not K3's bits")
                    t = timings(fn, iters=20)
                    times[name].append((t["chained_ms"], graph_ms(fn)))
                    attention_block.merged_group, attention_block._side_stream = rule, side
            for name, spec, n_streams in runs:
                rec = {"shape": (B, S), "variant": name,
                       "group": None if n_streams is None
                       else _variant_group(rule, spec, B, S, caps),
                       "streams": n_streams,
                       "chained_ms": min(c for c, _ in times[name]),
                       "graph_ms": min(g for _, g in times[name])}
                out.append(rec)
                print(f"k3m variant ({B}, {S}, {D}) {name}"
                      + ("" if n_streams is None else f" (group {rec['group']})")
                      + f": chained {rec['chained_ms']:.4f}, graph {rec['graph_ms']:.4f} ms",
                      flush=True)
    finally:
        attention_block.merged_group, attention_block._side_stream = rule, side
    return out


KERNELS = ("k1", "k1_bf16_gelu", "k2", "k2_bf16_gelu", "k3", "k3m", "k4",
           "k1_quick_gelu", "k2_quick_gelu", "k4_clip_l")


def shapes_of(kernel: str) -> tuple:
    """The (B, S) a kernel is timed at: K1's and K2's bf16 gelu at the first
    two of SHAPES (the second is the layer breakdown's, where they run), K2
    at step2's and the tower's batch, K1's quick_gelu at step2's, the
    ViT-L/14-336 kernels at their width's one shape, the others at all
    three."""
    if kernel in CLIP_L_KERNELS:
        return WIDTHS["clip_l"][1]
    if kernel in ("k1_bf16_gelu", "k2_bf16_gelu"):
        return SHAPES[:2]
    if kernel == "k2":
        return SHAPES[0], SHAPES[2]
    if kernel == "k1_quick_gelu":
        return SHAPES[:1]
    return SHAPES


def block_records(kernels=KERNELS, seed: int = 0) -> dict:
    """Every kernel of ``kernels`` at each of its shapes; the plain version
    timed at the first shape."""
    ops = {}
    out = {}
    for kernel in kernels:
        width = "clip_l" if kernel in CLIP_L_KERNELS else "vit_b"
        if width not in ops:
            ops[width] = operands(seed, width)
        shapes = shapes_of(kernel)
        out[kernel] = [block_record(kernel, s, ops[width], plain=i == 0)
                       for i, s in enumerate(shapes)]
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels", default=",".join(KERNELS))
    ap.add_argument("--out", default=None)
    ap.add_argument("--k3m_variants", action="store_true",
                    help="also time K3m's schedule variants against K3")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: the timings need the card", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    records = block_records(tuple(args.kernels.split(",")) if args.kernels else ())
    variants = k3m_variants(operands()) if args.k3m_variants else None
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "records": records, "k3m_variants": variants}, f,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
