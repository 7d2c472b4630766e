"""AWQ against RTN on the Qwen3-VL-8B judge's random weights, by depth.

    python -m emr2a_tpu_torch.tools.awq_depth [--layers 2 4 8 16 36] [--out FILE]

For each depth L and for the plain weights and JAX's outlier-embedding
fixture (``outlier_state``: 6 embedding channels scaled by 12, the loud
channels AWQ exists for; ``tests/test_awq._outlier_embed``): the judge's
first L decoder layers at full width (``random_state(seed=0)`` in bf16 on
the card, the judge phase's weights), and the logits of EVAL_TOKENS seeded
ids through the bf16 model, RTN int4 (``quantize_decoder``), int4_awq
(``awq_quantize_qwen_text_params`` on the backend's 4 x 256 calibration
ids, as ``quantize_decoder`` calls it) and the fold alone (AWQ's scales
folded into the bf16 weights, not quantized: output-preserving up to bf16
rounding). Prints one JSON line a (fixture, depth): each one's logits
cosine to bf16 at the last position and averaged over positions, the
sites with alpha > 0 and AWQ's seconds (host clock, the card
synchronised); ``--out`` writes the lines as a JSON list. Needs the card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import torch

from emr2a_tpu_torch.judge.qwen_backend import _calib_ids_from_tokenizer, quantize_decoder
from emr2a_tpu_torch.models import awq
from emr2a_tpu_torch.models import qwen3_vl as q
from emr2a_tpu_torch.models.convert import params_from_jax, params_to_jax
from emr2a_tpu_torch.tools.stub_tokenizer import WordTokenizer

OUTLIER_CHANNELS, OUTLIER_FACTOR, OUTLIER_SEED = 6, 12.0, 3
EVAL_TOKENS, EVAL_SEED = 512, 5


def outlier_state(state: dict) -> dict:
    """``state`` with JAX's outlier-embedding fixture applied to its token
    embedding (every other tensor shared)."""
    name = "language_model.embed_tokens.embedding"
    e = state[name]
    loud = np.random.RandomState(OUTLIER_SEED).choice(e.shape[1], OUTLIER_CHANNELS,
                                                      replace=False)
    loud = torch.as_tensor(loud, device=e.device)
    e = e.clone()
    e[:, loud] = (e[:, loud].float() * OUTLIER_FACTOR).to(e.dtype)
    return {**state, name: e}


def awq_cosines(cfg, state: dict, layers: int, tok, fold_only: bool = False) -> dict:
    """The logits cosines to bf16 of int4, int4_awq (and with ``fold_only``
    the fold alone) on ``state``'s first ``layers`` decoder layers, each
    {"last", "mean"}, with AWQ's report, its alpha > 0 sites and seconds."""
    c = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, num_layers=layers))
    sub = {k: v for k, v in state.items()
           if not k.startswith("language_model.layers.") or int(k.split(".")[2]) < layers}
    dev = state["language_model.embed_tokens.embedding"].device
    ids = torch.as_tensor(np.random.RandomState(EVAL_SEED).randint(
        2, c.text.vocab_size, (1, EVAL_TOKENS)), device=dev)
    pos = torch.arange(EVAL_TOKENS, device=dev)[None, None].expand(3, 1, EVAL_TOKENS)
    bf16 = q.Qwen3VLModel.from_params(c, sub)

    def logits(model) -> torch.Tensor:
        with torch.inference_mode():
            return model(ids, pos)[0][0].float()

    ref = logits(bf16)
    calib = _calib_ids_from_tokenizer(tok, c.text.vocab_size)
    t0 = time.time()
    tree, report = awq.awq_quantize_qwen_text_params(bf16, params_to_jax(sub), calib,
                                                     return_report=True)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    out = {"layers": layers, "awq_s": time.time() - t0, "report": report,
           "alpha_pos": sorted(f"{ln}.{s}" for ln, e in report.items()
                               for s, a in e["alpha"].items() if a > 0)}
    models = {"int4": lambda: quantize_decoder(sub, "int4"),
              "int4_awq": lambda: params_from_jax(tree)}
    if fold_only:
        def folded():
            t = params_to_jax(sub)
            scales = awq.compute_awq_scales(t["language_model"], awq.collect_awq_stats(bf16, calib),
                                            c.text.num_heads, c.text.num_kv_heads,
                                            c.text.head_dim)
            t["language_model"] = awq.fold_awq_scales(t["language_model"], scales,
                                                      c.text.num_kv_heads, c.text.head_dim)
            return params_from_jax(t)
        models["fold_only"] = folded
    for name, build in models.items():
        per_pos = torch.nn.functional.cosine_similarity(
            logits(q.Qwen3VLModel.from_params(c, build())), ref, dim=-1)
        out[name] = {"last": float(per_pos[-1]), "mean": float(per_pos.mean())}
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, nargs="+", default=[2, 4, 8, 16, 36])
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = q.qwen3_vl_8b_config(torch.bfloat16)
    state = q.random_state(cfg, seed=0, device="cuda")
    tok = WordTokenizer()
    rows = []
    for outlier in (False, True):
        st = outlier_state(state) if outlier else state
        for layers in args.layers:
            row = {"outlier": outlier, **awq_cosines(cfg, st, layers, tok, fold_only=True)}
            row.pop("report")
            rows.append(row)
            print(json.dumps(row), flush=True)
            torch.cuda.empty_cache()
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()
