"""A CPU rehearsal of the benchmark's ``kimi-vl-a3b.audit-think`` cell at its
own small sizes (the published widths stay in the configuration file):

- ``build_context`` / ``run_cell`` at ``--trace 0`` and ``1``: the cell
  comes out ``correct`` against the plain reference, reports
  ``audit_cases_per_s`` and ``setup_s``, and traced, each new per-layer
  reader gives a number or, where it reads the device (on the CPU there
  is none), nothing;
- a program without the tracer leaves the counters' metrics out;
- a program without the Kimi backend fails as the adapter loads;
- planted faults (routing without the correction bias, the routing scale
  1.0, one slot's latent cache halved in decode) each lift a judged number
  to 4 x its sound reading;
- the judge's alignment of a slot's route records to the judged sequence;
- hand-checked counts of ``judge_mfu.audit-think`` and
  ``k11_roofline.audit-think`` at the published widths, and K11's kernels
  found by name.
"""

import functools
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import pytest

REPO = Path(__file__).resolve().parents[1]
CELL = "kimi-vl-a3b.audit-think"
SMALL = {"vision_config": {"patch_size": 14, "init_pos_emb_height": 4, "init_pos_emb_width": 4,
                           "num_attention_heads": 2, "num_hidden_layers": 2, "hidden_size": 32,
                           "intermediate_size": 64, "merge_kernel_size": [2, 2]},
         "hidden_size": 64, "num_hidden_layers": 3, "num_attention_heads": 4,
         "kv_lora_rank": 32, "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16,
         "intermediate_size": 96, "moe_intermediate_size": 32, "n_routed_experts": 8,
         "num_experts_per_tok": 3}
MIX = {"wave": 6, "cases_per_unit": 6, "warm_cases": 3, "patients": 8, "image_size": 56,
       "budgets": [4, 12], "slots": 4, "trace_units": 1}
HOST_READ = ("prepare_ms.audit-think", "expert_mb_per_token.audit-think",
             "judge_mfu.audit-think", "device_idle_pct.audit-think",
             "decode_use_pct.audit-think")
DEVICE_READ = ("k11_roofline.audit-think", "decode_step_ms.audit-think",
               "k8_roofline.audit-think", "prefill_mfu.audit-think",
               "serving_idle_pct.audit-think")


def run(trace: int, seed: int = 2**31 + 11) -> dict:
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    from benchmark.core.harness import build_context, run_cell
    args = SimpleNamespace(workload=CELL, seed=seed, seconds=0.3, trace=trace)
    ctx = build_context(args, REPO, "cpu", SMALL, MIX)
    return run_cell(ctx, 0.3, time.perf_counter())


@pytest.mark.parametrize("trace", [0, 1])
def test_rehearsal(trace):
    from benchmark.core import registry
    from benchmark.core.harness import result_line

    out = run(trace)
    line = result_line(out)
    assert line["correct"] is True, line["checks"]
    assert set(line["checks"]) == {"route_margin", "token_gap", "token_gap_mean"}
    assert line["attempted"] > 0 and line["failed"] == 0
    assert line["attempted"] % MIX["cases_per_unit"] == 0
    metrics = line["metrics"]
    bench = registry.load_benchmark(REPO)
    if trace:
        want = {m["name"] for m in registry.metrics_of(bench, CELL, "per_layer")}
        assert want == set(HOST_READ) | set(DEVICE_READ)
        for name in HOST_READ:
            assert isinstance(metrics[name]["value"], float), name
        assert not set(DEVICE_READ) & set(metrics)
    else:
        assert set(metrics) == {"audit_cases_per_s", "setup_s"}
    json.loads(json.dumps(line))


def test_without_the_tracer(monkeypatch):
    from emr2a_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "snapshot")
    out = run(1)
    assert out["correct"], out["checks"]
    assert "expert_mb_per_token.audit-think" not in out["metrics"]
    assert "prepare_ms.audit-think" not in out["metrics"]
    assert "judge_mfu.audit-think" in out["metrics"]


def test_program_without_the_backend_fails_at_load(monkeypatch, tmp_path):
    """A program from before the Kimi judge (no ``judge.kimi_backend``) fails
    as the adapter is loaded, before any set-up."""
    import shutil

    from benchmark.core import registry

    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    monkeypatch.setitem(sys.modules, "emr2a_tpu_torch.judge.kimi_backend", None)
    with pytest.raises(ImportError):
        registry.system("kimi_vl", tmp_path)


def published():
    return json.loads((REPO / "benchmark" / "configs" / "kimi-vl-a3b.json").read_text())


def metric(name):
    from benchmark.core import registry
    return registry.metric(name, REPO)


def test_judge_mfu_counts_by_hand():
    m, cfg = metric("judge_mfu.audit-think"), published()
    # an expert layer a token: q 2*2048*3072, kv_a 2*2048*576, kv_b 2*512*4096,
    # o 2*2048*2048, router 2*2048*64, 6 experts 6*6*2048*1408, shared 6*2048*2816
    moe_layer = (12582912 + 2359296 + 4194304 + 8388608 + 262144 + 103809024 + 34603008)
    dense_layer = 12582912 + 2359296 + 4194304 + 8388608 + 6 * 2048 * 11264
    assert m._layer_linear(cfg, 1) == moe_layer == 166199296
    assert m._layer_linear(cfg, 0) == dense_layer == 165937152
    # two tokens at positions 0 and 1: attention over 1 + 2 keys, 2*16*(192+128) a key
    assert m._token_flops(cfg, 0, 2) == 2 * (dense_layer + 26 * moe_layer) + 27 * 10240 * 3
    # a 504 x 504 image: 1296 patches, 324 merged tokens
    N, D = 1296, 1152
    tower = 2 * N * 588 * D + 27 * (8 * N * D * D + 4 * N * N * D + 4 * N * D * 4304)
    assert m.image_flops(cfg, (1, 36, 36)) == tower + 324 * (2 * 4608 ** 2 + 2 * 4608 * 2048)


def test_k11_least_time_by_hand():
    from benchmark.core.peaks import BF16_FLOPS, HBM_BYTES
    m, cfg = metric("k11_roofline.audit-think"), published()
    # a decode step of 16 slots: 96 pairs over 51 distinct experts
    expert = 3 * 2048 * 1408 * 2                    # 17,301,504 bytes
    nbytes = 51 * expert + 16 * 2048 * (2 + 4)
    assert m.least(cfg, 96, 51) == pytest.approx(nbytes / HBM_BYTES)
    # a 2,510-token refill: 15,060 pairs over all 64 experts, about 235 rows
    # an expert: 229 operations a byte, under the card's 295, so still the
    # bytes' side (0.34 ms of bytes against 0.26 ms of operations)
    ops = 6 * 2048 * 1408 * 15060
    nbytes = 64 * expert + 2510 * 2048 * (2 + 4)
    assert m.least(cfg, 15060, 64) == pytest.approx(max(ops / BF16_FLOPS, nbytes / HBM_BYTES))
    # 16 refills at once (40,160 tokens): bound by operations
    assert m.least(cfg, 16 * 15060, 64) == pytest.approx(16 * ops / BF16_FLOPS)


def numbers(out) -> dict:
    return {name: c["value"] for name, c in out["checks"].items()}


@functools.lru_cache(maxsize=None)
def sound_numbers() -> tuple:
    return tuple(numbers(run(0)).items())


# below these a reading is rounding on the CPU test's small widths
FLOORS = {"route_margin": 1e-4, "token_gap": 1e-3, "token_gap_mean": 1e-5}


def faulty_run(monkeypatch, fault: str) -> dict:
    """The rehearsal with a fault planted in the program: ``bias`` routes
    without the correction bias, ``scale`` weighs the experts by 1.0 in
    place of 2.446, ``slot`` reads slot 1's latent cache at half its value
    in decode."""
    from dataclasses import replace

    import torch

    from benchmark.core import registry
    from emr2a_tpu_torch.models import kimi_vl as kv

    if fault == "bias":
        route = kv.route
        monkeypatch.setattr(kv, "route", lambda x, router, bias, k, s:
                            route(x, router, torch.zeros_like(bias), k, s))
    elif fault == "scale":
        system = registry.system("kimi_vl", REPO)
        config = system.program_config
        monkeypatch.setattr(system, "program_config", lambda cfg: (lambda c: replace(
            c, text=replace(c.text, routed_scaling_factor=1.0)))(config(cfg)))
    else:
        absorbed = kv.KimiMLA.absorbed

        def half_slot(self, q_nope, q_pe, latent, mask):
            if latent.shape[0] > 1:
                latent = latent.clone()
                latent[1] *= 0.5
            return absorbed(self, q_nope, q_pe, latent, mask)

        monkeypatch.setattr(kv.KimiMLA, "absorbed", half_slot)
    return run(0)


@pytest.mark.parametrize("fault", ["bias", "scale", "slot"])
def test_planted_fault_moves_a_judged_number(monkeypatch, fault):
    """Each fault lifts at least one of the cell's compared numbers to 4 x
    its sound reading on the same seed (the cell's limits are set from the
    card's readings at the published widths; here the widths are small)."""
    sound = dict(sound_numbers())
    got = numbers(faulty_run(monkeypatch, fault))
    ratio = max(got[n] / max(sound[n], FLOORS[n]) for n in FLOORS)
    assert ratio >= 4, (sound, got)


def test_program_routes_follow_the_records():
    """The judge's alignment of a slot's records: the prompt at its rows,
    decoded tokens found in the ring by position, stale rows past the
    judged sequence ignored, a missing position refused."""
    import torch

    from benchmark.core import registry
    system = registry.system("kimi_vl", REPO)
    layers, L, bucket, tl, top_k = 2, 16, 6, 4, 3
    rec = torch.zeros(layers, L, 1 + top_k, dtype=torch.int32)
    rec[:, :tl, 0] = torch.arange(1, tl + 1)
    rec[:, :tl, 1:] = 7
    rec[:, tl:bucket, 0] = 1                               # the prompt's padding
    for g, row in enumerate([9, 6, 10, 7]):                # ring rows out of order
        rec[:, row, 0] = tl + g + 1
        rec[:, row, 1:] = g
    rec[:, 11, 0] = tl + 3                                 # an overrun past the sequence
    out = system.program_routes({"routes": rec, "prompt_len": tl, "bucket": bucket}, tl + 2)
    assert out.shape == (layers, tl + 2, top_k)
    assert (out[:, :tl] == 7).all() and (out[:, tl] == 0).all() and (out[:, tl + 1] == 1).all()
    rec[1, 6, 0] = 0                                       # position tl + 1 lost in layer 1
    with pytest.raises(ValueError, match="miss 1 of"):
        system.program_routes({"routes": rec, "prompt_len": tl, "bucket": bucket}, tl + 2)
    with pytest.raises(ValueError, match="no route records"):
        system.program_routes({"routes": None, "prompt_len": tl, "bucket": bucket}, tl + 2)


def test_k11_reads_its_kernels_by_name():
    m = metric("k11_roofline.audit-think")
    by_name = {"void emr2a::k11_gemm_kernel<16, 64, 64, 1, 4, 4, true>(emr2a::MoeArgs)": 2.0,
               "emr2a::k11_align_kernel(long long const*, int, int, int, int, int*, int*, "
               "long long*)": 0.5, "ampere_bf16_s16816gemm_bf16_128x64": 9.0}
    assert m.device_seconds(SimpleNamespace(device=SimpleNamespace(by_name=by_name))) == 2.5
    assert m.device_seconds(SimpleNamespace(device=None)) == 0.0
