"""Per-stage timing breakdown of the BioMedCLIP embed path at bench shapes.

Port of ``scripts/exp_layer_breakdown.py``, with its flags, defaults,
shapes (ViT-B/16 at full width: B = 96, S = 197 or 200, d = 768, m = 3072,
12 heads, 12 layers) and inputs (``np.random.RandomState(0)``, drawn in the
script's order), plus ``--device`` (default ``cuda``; ``cpu`` runs the
kernels' plain versions, for the tests):

    python -m emr2a_tpu_torch.tools.layer_breakdown --what tune --merge_batch
    python -m emr2a_tpu_torch.tools.layer_breakdown --what int8block --act_bf16

``--what`` is a comma list of ``full``, ``attn``, ``mlp``, ``rest``,
``batches``, ``tune``, ``int8block``, ``nlayers`` and ``stem`` (``all`` is
full, attn, mlp and rest). Routing: ``attn`` runs K3, ``mlp`` K1, ``tune``
K3 and K1 (K3m and K1 with ``--merge_batch``; K4 and K2 with ``--int8``),
``int8block`` K4 and K2, ``nlayers`` the ``TransformerBlock`` stack (K3,
K1), ``full`` / ``batches`` / ``stem`` the image tower. ``--block_b``,
``--head_group``, ``--tile``, ``--activation`` and ``--act_bf16`` reach
the ops as the script passes them (``head_group``, ``tile``, and
``block_b`` without ``--merge_batch``, are ignored there: TPU VMEM
knobs).

Timing: the script chains ``lax.scan`` iterations inside one jit and
subtracts the relay's round trip. Here each measurement calls the step
``--iters`` times eagerly, carrying its output into the next call with the
script's perturbation (``+ c * 1e-9``) and ``* 0.5``; one chain warms up,
then the least of three chains timed between two CUDA events (a host clock
on the CPU, where the numbers are the plain versions' and no device
metric) gives ms/iter. There is no round trip to subtract. ``main``
returns each measurement's ms and the number of step calls it made, so a
caller can hold the kernels' launch counts against it.

The 224x224 uint8 images of ``full``, ``stem`` and ``batches`` need no
device resize (``ops/preprocess.py``), so those stages time none.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

REPEATS = 3   # timed chains per measurement; the least is reported


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=96)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--what", default="all",
                    help="comma list: full,attn,mlp,rest,batches,tune,"
                         "int8block,nlayers,stem")
    ap.add_argument("--batches", default="128,160,192,256",
                    help="batch sizes for --what batches")
    ap.add_argument("--tile", type=int, default=256, help="mlp tile (tune mode)")
    ap.add_argument("--head_group", type=int, default=6)
    ap.add_argument("--block_b", type=int, default=4)
    ap.add_argument("--merge_batch", action="store_true")
    ap.add_argument("--activation", default="gelu")
    ap.add_argument("--act_bf16", action="store_true")
    ap.add_argument("--int8", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


class Timer:
    """ms per call of a chained step on one device: CUDA events on a card,
    the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.device = device
        self.results: Dict[str, dict] = {}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def chain_ms(self, run: Callable[[], None]) -> float:
        """Least wall of REPEATS calls of ``run`` after one warm-up, in ms."""
        run()
        self._sync()
        best = float("inf")
        for _ in range(REPEATS):
            if self.device.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                run()
                end.record()
                end.synchronize()
                best = min(best, start.elapsed_time(end))
            else:
                t0 = time.perf_counter()
                run()
                best = min(best, (time.perf_counter() - t0) * 1e3)
        return best

    def timed_chain(self, fn, x0: torch.Tensor, iters: int, tag: str) -> float:
        """fn: (carry, c) -> carry-like; returns per-iteration ms."""
        ms = self.chain_ms(lambda: _chain(fn, x0, iters)) / iters
        self.record(tag, ms, iters)
        print(f"{tag:42s} {ms:8.3f} ms/iter", flush=True)
        return ms

    def record(self, tag: str, ms: float, iters: int) -> None:
        """The measurement's ms/iter and its step calls (warm-up included)."""
        self.results[tag] = {"ms": ms, "calls": (1 + REPEATS) * iters}


def _image_tower(num_layers: Optional[int], device: torch.device):
    """BioMedCLIP's image tower, bf16 with the fused blocks, random weights
    from seed 0 (the script's tower is flax-initialised from PRNGKey(0):
    the two packages' random towers differ)."""
    from emr2a_tpu_torch.encoders.biomedclip_encoder import default_biomedclip_config
    from emr2a_tpu_torch.encoders.jit_encoder import fast_config
    from emr2a_tpu_torch.models.clip import BioMedCLIPImageTower, init_tower

    config = fast_config(dataclasses.replace(default_biomedclip_config(),
                                             text=None))
    if num_layers is not None:
        config = dataclasses.replace(config, vision=dataclasses.replace(
            config.vision, num_layers=num_layers))
    tower = init_tower(BioMedCLIPImageTower(config),
                       torch.Generator().manual_seed(0))
    return tower.to(device).eval()


def _tower_step(tower, imgs):
    from emr2a_tpu_torch.ops.preprocess import (
        BIOMEDCLIP_PREPROCESS,
        preprocess_images,
    )

    def step(carry, c):
        px = preprocess_images(imgs, BIOMEDCLIP_PREPROCESS)
        px = px + carry.reshape(-1)[0] * 1e-9
        f = tower(px.to(torch.bfloat16)).float()
        f = f / (torch.linalg.vector_norm(f, dim=-1, keepdim=True) + 1e-12)
        return carry + f.sum() * 1e-9
    return step


def main(argv=None) -> Dict[str, dict]:
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a CUDA card; pass --device cpu "
                           "for the plain versions")
    what = set(args.what.split(","))
    timer = Timer(device)
    print(f"device: {torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'}"
          f" ({'CUDA events' if device.type == 'cuda' else 'host clock, plain versions'})",
          flush=True)
    with torch.inference_mode():
        _run(args, what, device, timer)
    return timer.results


def _run(args, what: set, device: torch.device, timer: Timer) -> None:
    from emr2a_tpu_torch.ops.attention_block import (
        fused_ln_attention,
        fused_ln_attention_int8,
    )
    from emr2a_tpu_torch.ops.mlp import (
        fused_ln_mlp,
        fused_ln_mlp_int8,
        quantize_weight_int8,
    )

    B, S, d, H, m = args.batch, 197, 768, 12, 3072
    rng = np.random.RandomState(0)
    bf16 = torch.bfloat16
    on = lambda a, dtype=None: torch.as_tensor(np.asarray(a), device=device,
                                              dtype=dtype)
    mk = lambda *sh: on(rng.randn(*sh) * 0.02, bf16)
    act_dtype = bf16 if args.act_bf16 else torch.float32
    half = torch.tensor(0.5, dtype=bf16, device=device)

    def perturb(carry, c):
        return carry + torch.tensor(c * 1e-9, dtype=carry.dtype, device=device)

    if {"full", "rest", "all"} & what:
        tower = _image_tower(None, device)

    if {"full", "all"} & what:
        imgs = on(rng.randint(0, 256, (B, 224, 224, 3), np.uint8))
        x0 = torch.zeros((1, 1, 1, 1), device=device)
        ms = timer.chain_ms(lambda: _chain(_tower_step(tower, imgs), x0,
                                           args.iters)) / args.iters
        timer.record(f"full tower (batch {B})", ms, args.iters)
        print(f"{'full tower (batch %d)' % B:42s} {ms:8.3f} ms/iter "
              f"= {B * 1e3 / ms:8.1f} slices/s", flush=True)

    if {"attn", "all"} & what:
        x = on(rng.randn(B, S, d) * 0.5, bf16)
        wq, wk, wv, wo = mk(d, d), mk(d, d), mk(d, d), mk(d, d)
        bq, bk, bv, bo = mk(d), mk(d), mk(d), mk(d)
        s = on(rng.rand(d) * 0.1 + 1, bf16)
        b = mk(d)

        def attn_iter(carry, c):
            y = fused_ln_attention(perturb(carry, c), s, b, wq, bq, wk, bk,
                                   wv, bv, wo, bo, num_heads=H,
                                   head_group=6, block_b=4)
            return y * half  # keep magnitudes bounded

        timer.timed_chain(attn_iter, x, args.iters, "fused_ln_attention/layer")

    if {"mlp", "all"} & what:
        T = B * S
        x2 = on(rng.randn(T, d) * 0.5, bf16)
        w1, b1, w2, b2 = mk(d, m), mk(m), mk(m, d), mk(d)
        s2 = on(rng.rand(d) * 0.1 + 1, bf16)
        bb2 = mk(d)

        def mlp_iter(carry, c):
            y = fused_ln_mlp(perturb(carry, c), s2, bb2, w1, b1, w2, b2,
                             activation="gelu", tile=256)
            return y * half

        timer.timed_chain(mlp_iter, x2, args.iters, f"fused_ln_mlp/layer (T={T})")

    if {"int8block"} & what or ({"tune"} & what and args.int8):
        # W8A8 composed block at bench shapes
        x = on(rng.randn(B, 200, d) * 0.5, bf16)
        mkf = lambda *sh: rng.randn(*sh).astype(np.float32) * 0.02
        qw = [quantize_weight_int8(mkf(d, d)) for _ in range(4)]
        qdev = [(on(q), on(sc.reshape(-1))) for q, sc in qw]
        biases = [on(mkf(d), bf16) for _ in range(4)]
        s1 = on(rng.rand(d) * 0.1 + 1, bf16)
        b1v = on(mkf(d), bf16)
        q1, sc1 = (on(a) for a in quantize_weight_int8(mkf(d, m)))
        q2, sc2 = (on(a) for a in quantize_weight_int8(mkf(m, d)))
        sc1, sc2 = sc1.reshape(-1), sc2.reshape(-1)
        bb1 = on(mkf(m), bf16)
        bb2 = on(mkf(d), bf16)
        s2 = on(rng.rand(d) * 0.1 + 1, bf16)
        b2v = on(mkf(d), bf16)

        def block_iter8(carry, c):
            y = fused_ln_attention_int8(
                perturb(carry, c), s1, b1v,
                qdev[0][0], qdev[0][1], biases[0],
                qdev[1][0], qdev[1][1], biases[1],
                qdev[2][0], qdev[2][1], biases[2],
                qdev[3][0], qdev[3][1], biases[3],
                num_heads=H, head_group=args.head_group,
                block_b=args.block_b, valid_len=197)
            y2 = fused_ln_mlp_int8(y.reshape(B * 200, d), s2, b2v,
                                   q1, sc1, bb1, q2, sc2, bb2,
                                   act_dtype=act_dtype,
                                   tile=args.tile).reshape(B, 200, d)
            return y2 * half

        timer.timed_chain(block_iter8, x, args.iters,
                          f"int8 block bb={args.block_b} hg={args.head_group} "
                          f"tile={args.tile}"
                          f"{' act=bf16' if args.act_bf16 else ''}")

    if {"tune"} & what and not args.int8:
        # One composed block with explicit kernel parameters, for
        # (block_b, head_group, mlp tile) sweeps.
        x = on(rng.randn(B, 200, d) * 0.5, bf16)
        wq, wk, wv, wo = mk(d, d), mk(d, d), mk(d, d), mk(d, d)
        bq, bk, bv, bo = mk(d), mk(d), mk(d), mk(d)
        s1 = on(rng.rand(d) * 0.1 + 1, bf16)
        b1v = mk(d)
        w1, bb1, w2, bb2 = mk(d, m), mk(m), mk(m, d), mk(d)
        s2 = on(rng.rand(d) * 0.1 + 1, bf16)
        b2v = mk(d)

        def block_iter(carry, c):
            y = fused_ln_attention(
                perturb(carry, c), s1, b1v,
                wq, bq, wk, bk, wv, bv, wo, bo, num_heads=H,
                head_group=args.head_group, block_b=args.block_b,
                valid_len=197, merge_batch=args.merge_batch)
            y2 = fused_ln_mlp(y.reshape(B * 200, d), s2, b2v,
                              w1, bb1, w2, bb2, activation=args.activation,
                              act_dtype=act_dtype,
                              tile=args.tile).reshape(B, 200, d)
            return y2 * half

        timer.timed_chain(block_iter, x, args.iters,
                          f"block bb={args.block_b} hg={args.head_group} "
                          f"tile={args.tile} merge={args.merge_batch} "
                          f"act={args.activation}{'/bf16' if args.act_bf16 else ''}")

    if {"nlayers"} & what:
        # N real TransformerBlocks (the tower's layer stack, no stem),
        # chained: the full-vs-isolated per-layer gap.
        from emr2a_tpu_torch.models.clip import init_tower
        from emr2a_tpu_torch.models.layers import TransformerBlock

        for n_layers in (1, 2, 4, 12):
            stack = torch.nn.ModuleList(
                TransformerBlock(d, H, m, activation="gelu", ln_eps=1e-6,
                                 dtype=bf16, fused_mlp=True, fused_attn=True)
                for _ in range(n_layers))
            stack = init_tower(stack, torch.Generator().manual_seed(0)).to(device)
            x = on(rng.randn(B, 200, d) * 0.5, bf16)

            def stack_iter(carry, c, stack=stack):
                y = perturb(carry, c)
                for block in stack:
                    y = block(y, valid_len=197)
                return y * half

            ms = timer.timed_chain(stack_iter, x, args.iters,
                                   f"{n_layers}-layer stack")
            print(f"{'':42s} {ms / n_layers:8.3f} ms/layer", flush=True)

    if {"stem"} & what:
        # stem+pool only: a 0-layer tower isolates everything the
        # transformer layers are not (preprocess, patchify, pos-embed,
        # final LN, cls pool, projection, L2)
        from emr2a_tpu_torch.ops.preprocess import (
            BIOMEDCLIP_PREPROCESS,
            preprocess_images,
        )

        tower0 = _image_tower(0, device)
        imgs = on(rng.randint(0, 256, (B, 224, 224, 3), np.uint8))

        def with_c(c):
            im = imgs.clone()
            im[0, 0, 0, 0] = int(c) % 256
            return im

        step0 = lambda carry, c: _tower_step(tower0, with_c(c))(carry, c)
        x0 = torch.zeros((), device=device)
        ms = timer.chain_ms(lambda: _chain(step0, x0, args.iters)) / args.iters
        tag = "stem+pool (0-layer tower, batch %d)" % B
        timer.record(tag, ms, args.iters)
        print(f"{tag:42s} {ms:8.3f} ms/iter", flush=True)

        def pre_iter(carry, c):
            px = preprocess_images(with_c(c), BIOMEDCLIP_PREPROCESS)
            return carry + px.sum() * 1e-9

        ms = timer.chain_ms(lambda: _chain(pre_iter, x0, args.iters)) / args.iters
        tag = "preprocess only (batch %d)" % B
        timer.record(tag, ms, args.iters)
        print(f"{tag:42s} {ms:8.3f} ms/iter", flush=True)

    if {"rest", "all"} & what:
        from emr2a_tpu_torch.ops.preprocess import (
            BIOMEDCLIP_PREPROCESS,
            preprocess_images,
        )

        imgs = on(rng.randint(0, 256, (B, 224, 224, 3), np.uint8))

        def pre_only(carry, c):
            px = preprocess_images(imgs, BIOMEDCLIP_PREPROCESS)
            px = px + carry.reshape(-1)[0] * 1e-9
            return carry + px.sum() * 1e-9

        x0 = torch.zeros((1, 1, 1), device=device)
        ms = timer.chain_ms(lambda: _chain(pre_only, x0, args.iters)) / args.iters
        timer.record("preprocess only", ms, args.iters)
        print(f"{'preprocess only':42s} {ms:8.3f} ms/iter", flush=True)

    if {"batches"} & what:
        for bb in (int(v) for v in args.batches.split(",")):
            tower = _image_tower(None, device)
            imgs = on(rng.randint(0, 256, (bb, 224, 224, 3), np.uint8))
            x0 = torch.zeros((), device=device)
            ms = timer.chain_ms(lambda: _chain(_tower_step(tower, imgs), x0,
                                               args.iters)) / args.iters
            timer.record(f"batch {bb}", ms, args.iters)
            print(f"batch {bb:4d}: {bb * 1e3 / ms:8.1f} slices/s "
                  f"({ms:.2f} ms/batch)", flush=True)


def _chain(step, x0, iters: int):
    carry = x0
    for i in range(iters):
        carry = step(carry, float(i))
    return carry


if __name__ == "__main__":
    main()
