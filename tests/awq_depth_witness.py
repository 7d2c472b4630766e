"""AWQ against RTN on plain random weights at the 8B judge's layer widths,
computed by both packages on the same weights: a second witness, beside
the port, for what AWQ's recipe does where no channel is loud.

For each depth, the port's seeded random state (``random_state(seed=0)``,
every kernel N(0, 0.02), f32, on the CPU) at the 8B's text widths (hidden
4096, intermediate 12288, 32 / 8 heads of 128), its vocabulary cut to
``--vocab`` rows so that the run fits a host (calibration and evaluation
ids are taken modulo it), goes through JAX's
``awq_quantize_qwen_text_params`` and the port's on the same 4 x 256
calibration ids (the judge's prompts through the stub tokenizer, as the
backend calibrates). It prints, as one JSON line a depth: the sites where
each package takes alpha > 0, whether the alphas agree, the count of int4
codes that differ, the summed diagonal site errors (AWQ and RTN), and the
logits cosine to the f32 model over 512 seeded evaluation ids (last
position and mean over positions) for RTN int4, the port's int4_awq and
JAX's int4_awq, all three read through the port's W4A8 forward (its plain
version on the CPU). ``--outlier`` applies JAX's outlier-embedding fixture
(``tests/test_awq._outlier_embed``) first.

Run from the repository's root (a few minutes; at 4 layers each package
holds 3.1 GB of f32 decoder weights):

    JAX_PLATFORMS=cpu python -m tests.awq_depth_witness --layers 2 4
"""

from __future__ import annotations

import argparse
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from emr2a_tpu.models import awq as jax_awq
from emr2a_tpu.models import qwen3_vl as jq
from emr2a_tpu_torch.judge.qwen_backend import _calib_ids_from_tokenizer, quantize_decoder
from emr2a_tpu_torch.models import awq
from emr2a_tpu_torch.models import qwen3_vl as pq
from emr2a_tpu_torch.models.convert import params_from_jax, params_to_jax
from emr2a_tpu_torch.tools.stub_tokenizer import WordTokenizer
from tests.test_awq import _outlier_embed

_VISION = dict(depth=1, hidden_size=32, out_hidden_size=4096, num_heads=2, patch_size=4,
               temporal_patch_size=1, spatial_merge_size=2, intermediate_size=48,
               num_position_embeddings=64, deepstack_visual_indexes=(0,))


def configs(layers: int, vocab: int):
    text = dict(vocab_size=vocab, num_layers=layers, tie_word_embeddings=False)
    port = pq.Qwen3VLConfig(vision=pq.QwenVisionConfig(**_VISION),
                            text=pq.QwenTextConfig(**text))
    jax_cfg = jq.Qwen3VLConfig(vision=jq.QwenVisionConfig(**_VISION),
                               text=jq.QwenTextConfig(**text))
    return port, jax_cfg


def cosines(logits: torch.Tensor, ref: torch.Tensor) -> tuple:
    c = torch.nn.functional.cosine_similarity(logits.double(), ref.double(), dim=-1)
    return float(c[-1]), float(c.mean())


def witness(layers: int, vocab: int, outlier: bool) -> dict:
    cfg, jcfg = configs(layers, vocab)
    state = pq.random_state(cfg, seed=0, device="cpu")
    jparams = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), params_to_jax(state))
    if outlier:
        jparams = _outlier_embed(jparams, None)
        state = {**state, **params_from_jax(
            {"language_model": {"embed_tokens": jparams["language_model"]["embed_tokens"]}})}
    calib = _calib_ids_from_tokenizer(WordTokenizer(), 151936) % vocab
    evalids = torch.as_tensor(np.random.RandomState(5).randint(2, vocab, (1, 512)))

    t0 = time.time()
    jtree, jrep = jax_awq.awq_quantize_qwen_text_params(jq.Qwen3VLModel(jcfg), jparams, calib,
                                                        return_report=True)
    jax_s = time.time() - t0
    del jparams
    model = pq.Qwen3VLModel.from_params(cfg, state)
    t0 = time.time()
    ptree, prep = awq.awq_quantize_qwen_text_params(model, params_to_jax(state), calib,
                                                    return_report=True)
    port_s = time.time() - t0

    differing = total = 0
    for layer in prep:
        for proj, entry in ptree["language_model"][layer].items():
            if isinstance(entry, dict) and "kernel_p4" in entry:
                want = np.asarray(jtree["language_model"][layer][proj]["kernel_p4"])
                differing += int((entry["kernel_p4"].numpy() != want).sum())
                total += want.size

    pos = torch.arange(512)[None, None].expand(3, 1, 512)

    def logits(params) -> torch.Tensor:
        with torch.inference_mode():
            return pq.Qwen3VLModel.from_params(cfg, params)(evalids, pos)[0][0].float()

    ref = logits(state)
    taken = lambda rep: sorted(f"{ln}.{s}" for ln, e in rep.items()
                               for s, a in e["alpha"].items() if a > 0)
    err = lambda rep, kind: sum(e["err"][s][kind] for e in rep.values() for s in e["err"])
    return {
        "layers": layers, "vocab": vocab, "outlier": outlier,
        "alpha_pos_port": taken(prep), "alpha_pos_jax": taken(jrep),
        "alphas_equal": {ln: e["alpha"] for ln, e in prep.items()}
        == {ln: e["alpha"] for ln, e in jrep.items()},
        "int4_codes_differing": differing, "int4_codes": total,
        "site_err_awq_port": err(prep, "awq"), "site_err_awq_jax": err(jrep, "awq"),
        "site_err_rtn_port": err(prep, "rtn"), "site_err_rtn_jax": err(jrep, "rtn"),
        "cos_int4": cosines(logits(quantize_decoder(state, "int4")), ref),
        "cos_int4_awq_port": cosines(logits(params_from_jax(ptree)), ref),
        "cos_int4_awq_jax": cosines(logits(params_from_jax(jtree)), ref),
        "awq_s_jax": jax_s, "awq_s_port": port_s,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, nargs="+", default=[2, 4])
    ap.add_argument("--vocab", type=int, default=8192)
    ap.add_argument("--outlier", action="store_true")
    args = ap.parse_args(argv)
    torch.set_num_threads(4)
    for layers in args.layers:
        print(json.dumps(witness(layers, args.vocab, args.outlier)), flush=True)


if __name__ == "__main__":
    main()
