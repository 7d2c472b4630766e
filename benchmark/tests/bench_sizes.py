"""Test sizes: the cells' configurations and mixes cut so that a run takes
seconds on the CPU (the published widths stay in the configuration files)."""

import time
from pathlib import Path
from types import SimpleNamespace

REPO = Path(__file__).resolve().parents[2]

BIOMEDCLIP = {"hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4,
              "intermediate_size": 128, "projection_dim": 32,
              "database": {"cases": 5000, "dim": 32, "dtype": "float32", "scan": "K6"}}
QWEN = {"vision": {"depth": 3, "hidden_size": 32, "intermediate_size": 64, "num_heads": 2,
                   "in_channels": 3, "patch_size": 16, "temporal_patch_size": 2,
                   "spatial_merge_size": 2, "out_hidden_size": 64, "num_position_embeddings": 16,
                   "deepstack_visual_indexes": [0, 1], "hidden_act": "gelu_pytorch_tanh"},
        "text": {"vocab_size": 151936, "hidden_size": 64, "num_hidden_layers": 2,
                 "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
                 "intermediate_size": 128, "rms_norm_eps": 1e-06, "rope_theta": 5000000,
                 "mrope_section": [4, 2, 2], "mrope_interleaved": True, "attention_bias": False,
                 "hidden_act": "silu", "tie_word_embeddings": False}}
CONFIG = {"biomedclip": BIOMEDCLIP, "qwen3-vl-8b": QWEN}
MIX = {"biomedclip.embed": {"batch": 8, "patients": 4, "slices_per_patient": 16,
                            "trace_units": 3},
       "biomedclip.query": {"slices": [4, 8], "patients": 4, "slices_per_patient": 16,
                            "trace_units": 3},
       "qwen3-vl-8b.audit": {"wave": 6, "cases_per_unit": 6, "warm_cases": 3, "patients": 8,
                             "image_size": 64, "budgets": [4, 12], "slots": 4, "trace_units": 1},
       "qwen3-vl-8b.audit-solo": {"wave": 6, "cases_per_unit": 1, "patients": 8,
                                  "image_size": 64, "budgets": [4, 12], "trace_units": 2,
                                  "close_every": 2}}
CELLS = tuple(MIX)


def context(workload: str, seed: int = 2**31 + 5, trace: int = 0, root: Path = REPO):
    from benchmark.core import registry
    from benchmark.core.harness import build_context

    bench = registry.load_benchmark(root)
    config = registry.workload(bench, workload)["config"]
    args = SimpleNamespace(workload=workload, seed=seed, seconds=0.5, trace=trace)
    return build_context(args, root, "cpu", CONFIG[config], MIX[workload])


def run(workload: str, seed: int = 2**31 + 5, trace: int = 0, seconds: float = 0.5) -> dict:
    from benchmark.core.harness import run_cell
    return run_cell(context(workload, seed, trace), seconds, time.perf_counter())
