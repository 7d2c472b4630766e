"""One run of one cell, as the benchmark's contract sets it out.

1. Refuse without the cards the cell asks for (exit 2, no result).
2. Set-up (``setup_s``, from the first line of ``benchmark/run.py``): the
   program's kernel library is loaded from ``build/kernels`` (built first
   in a checkout's first run: ``setup_s`` counts the build, as set-up
   counts compilation, and ``setup`` in the result line gives its seconds
   apart); the configuration's system adapter (``systems/<system>.py``)
   builds the program from the seed and warms up every shape of the
   cell's traffic. Then the device's peak memory is reset, so that
   ``memory_peak_bytes`` is the window's and not set-up's scratch.
3. The window: whole units of work (a batch, a case, a wave) in a closed
   loop, until the unit that ends at or after ``--seconds`` (and, where the
   mix sets ``close_every``, ends a block of that many units, so that every
   window holds whole blocks of the mix's sizes). With ``--trace 1`` the
   profiler covers the mix's first ``trace_units`` units.
4. The metrics: each is read by its own file under ``metrics/`` (end to
   end with ``--trace 0``, per layer with ``--trace 1``); a reader that
   finds nothing to read returns None and the metric is left out.
5. ``memory_peak_bytes`` is read, the program's state freed, and the
   adapter's ``judge`` runs the plain reference on what the window
   produced: ``correct`` is every compared number at or under its limit.
6. Refuse if JAX or the JAX package was ever loaded (exit 3, no result).
7. The compared numbers go to standard error, last, and the result line,
   with them under ``checks``, last, to standard output.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
from pathlib import Path
from types import SimpleNamespace

FORBIDDEN = ("jax", "jaxlib", "flax", "emr2a_tpu")


def _cache_dirs(root: Path) -> None:
    """Fixed cache directories inside the checkout, so that only the first
    run of a checkout builds (the kernel library's own is ``build/kernels``)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(root / "build" / sub)
    os.environ["USE_FLAX"] = "0"      # keep transformers, if anything imports it, off JAX
    os.environ["USE_JAX"] = "0"


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one of
    ``FORBIDDEN``, compared whole: ``emr2a_tpu_torch`` is not ``emr2a_tpu``."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def load_kernels() -> dict:
    """Loads the program's kernel library, building it first where the
    checkout has none yet: the build's seconds, and whether it was there."""
    from emr2a_tpu_torch.ops import _build

    prebuilt = _build.library_path().exists()
    t = time.perf_counter()
    _build.library()
    return {"kernel_build_s": time.perf_counter() - t, "kernels_prebuilt": prebuilt}


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def build_context(args, root: Path, device: str, overrides: dict = None,
                  mix_overrides: dict = None):
    """What an adapter is given: the cell's configuration, traffic and
    limits (``overrides`` and ``mix_overrides`` replace keys of the
    configuration and of the traffic mix: a test's size, a control's
    precision), the seed, the device and the tracer."""
    from benchmark.core import registry
    from benchmark.core.trace import Tracer

    bench = registry.load_benchmark(root)
    w = registry.workload(bench, args.workload)
    cfg = registry.config(bench, w["config"], root)
    cfg.update(overrides or {})
    mix = registry.traffic(w["traffic"], root)
    mix.update(mix_overrides or {})
    ctx = SimpleNamespace(
        bench=bench, workload=w, config=cfg, mix=mix,
        cell=registry.cell(w["name"], root), seed=args.seed, device=device, root=root,
        trace=bool(args.trace))
    kind = "per_layer" if args.trace else "end_to_end"
    ctx.metrics = [(m, registry.metric(m["name"], root))
                   for m in registry.metrics_of(bench, w["name"], kind)
                   if m["name"] != "setup_s"]
    probes = [(*mod.PROBE, mod.shape) for _, mod in ctx.metrics if hasattr(mod, "PROBE")]
    ctx.tracer = Tracer(probes, cuda=str(device).startswith("cuda"))
    ctx.system = registry.system(cfg["system"], root)
    return ctx


def run_cell(ctx, seconds: float, t0: float) -> dict:
    """Set-up, window, metrics and judgement of one run (no check for a
    card: the tests drive this on the CPU). Returns the result dict."""
    import torch

    cuda = str(ctx.device).startswith("cuda")
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    setup = load_kernels() if cuda else {}
    cell = ctx.system.build(ctx)
    cell.warm()
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats(0)
    setup_s = time.perf_counter() - t0

    records = []
    trace_units = int(ctx.mix.get("trace_units", 1)) if ctx.trace else 0
    close_every = int(ctx.mix.get("close_every", 1))
    if trace_units:
        ctx.tracer.start()
    start = time.perf_counter()
    while True:
        records.append(cell.step(len(records)))
        if trace_units and len(records) == trace_units:
            ctx.tracer.stop()
            d = ctx.tracer.device
            print(f"trace: events {dict(d.kinds)}, device s by probe {dict(d.by_label)}",
                  file=sys.stderr, flush=True)
        if (time.perf_counter() - start >= seconds and len(records) >= trace_units
                and len(records) % close_every == 0):
            break
    sync()
    window_s = time.perf_counter() - start
    times = sorted(r["seconds"] for r in records)
    print(f"window: {len(records)} units in {window_s:.3f} s; unit s min {times[0]:.4f} "
          f"median {times[len(times) // 2]:.4f} max {times[-1]:.4f}; first "
          f"{records[0]['seconds']:.4f} last {records[-1]['seconds']:.4f}", file=sys.stderr)

    run = SimpleNamespace(records=records, window_s=window_s, config=ctx.config, mix=ctx.mix,
                          spans=ctx.tracer.spans, calls=ctx.tracer.calls,
                          device=ctx.tracer.device,
                          traced=records[:trace_units] if trace_units else None)
    metrics = {}
    for entry, reader in ctx.metrics:
        value = reader.read(run)
        if value is not None:
            metrics[entry["name"]] = {"value": float(value), "unit": entry["unit"]}
    if not ctx.trace:
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
              "count": int(ctx.workload["chips"]) if cuda else 1,
              "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0)) if cuda else 0}
    out = {"attempted": sum(r["items"] for r in records),
           "failed": sum(r["failed"] for r in records), "metrics": metrics, "device": device,
           "setup": setup}
    if ctx.tracer.device is not None:
        device["busy_s"] = ctx.tracer.device.busy_s
        device["window_s"] = ctx.tracer.device.window_s
        out["breakdown"] = ctx.tracer.device.breakdown()

    cell.release()
    del cell
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ctx.diag = {}
    checks = ctx.system.judge(ctx, records)
    out["diagnostics"] = ctx.diag
    out["correct"] = bool(out["failed"] == 0 and all(v <= lim for _, v, lim in checks))
    out["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in checks}
    return out


def main(argv, t0: float) -> int:
    args = parse(argv)
    root = Path.cwd()
    _cache_dirs(root)
    import torch

    from benchmark.core import registry
    need = int(registry.workload(registry.load_benchmark(root), args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"benchmark: the cell needs {need} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    ctx = build_context(args, root, "cuda:0")
    out = run_cell(ctx, args.seconds, t0)
    found = forbidden_modules()
    if found:
        print(f"benchmark: forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    print(f"setup: {out['setup']!r}", file=sys.stderr)
    for name, value in out["diagnostics"].items():
        print(f"diag {name}: {value!r}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result_line(out)), flush=True)
    return 0


def result_line(out: dict) -> dict:
    """The last line's object: the contract's keys, the breakdown of a
    traced run, the kernel build's part of set-up, and the compared
    numbers with their limits last."""
    line = {k: out[k] for k in ("correct", "attempted", "failed", "metrics", "device")}
    if "breakdown" in out:
        line["breakdown"] = out["breakdown"]
    line["setup"] = out["setup"]
    line["checks"] = out["checks"]
    return line
