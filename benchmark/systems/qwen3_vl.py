"""Qwen3-VL's cells: step4's audit of a CV fold's predictions, through the
program's judge backend ``QwenVLBackend``: continuous serving
(``generate_stream`` over ``slots`` slots, a unit a wave of requests) or
one request at a time (``generate``, a unit a case), greedy.

Weights come from the reference's plan, drawn on the device from the seed
(``core/seeded.py``) and handed to the backend as its state dict (it takes
them as they are). The requests are step4's (``inputs/audit_request.py``)
over the synthetic cohort's CT-like slices (``inputs/ct_slices.py``),
tokenized by the frozen word tokenizer. The tokens each request was served
are read where the backend decodes them (``_decode_row``), and its prompt
ids, images and grids where it prepares them (``_prepare``, also the
``prepare`` span).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.core import registry, seeded
from benchmark.core.traffic import Schedule
from benchmark.inputs.audit_request import build_audit_request, patient, select_even
from benchmark.inputs.ct_slices import make_slices, rgb
from benchmark.inputs.word_tokenizer import WordTokenizer


def _program_config(cfg: dict):
    from emr2a_tpu_torch.models.qwen3_vl import Qwen3VLConfig, QwenTextConfig, QwenVisionConfig

    v, t = cfg["vision"], cfg["text"]
    vision = QwenVisionConfig(
        depth=v["depth"], hidden_size=v["hidden_size"], intermediate_size=v["intermediate_size"],
        num_heads=v["num_heads"], in_channels=v["in_channels"], patch_size=v["patch_size"],
        temporal_patch_size=v["temporal_patch_size"], spatial_merge_size=v["spatial_merge_size"],
        out_hidden_size=v["out_hidden_size"], num_position_embeddings=v["num_position_embeddings"],
        deepstack_visual_indexes=tuple(v["deepstack_visual_indexes"]), hidden_act=v["hidden_act"],
        dtype=torch.bfloat16)
    text = QwenTextConfig(
        vocab_size=t["vocab_size"], hidden_size=t["hidden_size"], num_layers=t["num_hidden_layers"],
        num_heads=t["num_attention_heads"], num_kv_heads=t["num_key_value_heads"],
        head_dim=t["head_dim"], intermediate_size=t["intermediate_size"],
        rms_norm_eps=t["rms_norm_eps"], rope_theta=float(t["rope_theta"]),
        mrope_section=tuple(t["mrope_section"]), attention_bias=t["attention_bias"],
        tie_word_embeddings=t["tie_word_embeddings"], hidden_act=t["hidden_act"],
        dtype=torch.bfloat16)
    return Qwen3VLConfig(vision=vision, text=text, image_token_id=cfg["image_token_id"],
                         vision_start_token_id=cfg["vision_start_token_id"])


class Cohort:
    """The pool's slices (as PIL images) and the audit requests of the
    traffic's cases: the query patient's even slices and the first even
    slice of each of its top neighbours."""

    def __init__(self, mix: dict, seed: int, device):
        from PIL import Image
        n_pat, per = int(mix["patients"]), int(mix["slices_per_patient"])
        self.query_depths = select_even(per, int(mix["query_slices"]))
        self.neighbor_depth = select_even(per, 2)[0]
        depths = sorted(set(self.query_depths) | {self.neighbor_depth})
        pats = np.repeat(np.arange(n_pat), len(depths))
        grey = make_slices(pats, np.tile(np.asarray(depths) / per, n_pat),
                           int(mix["image_size"]), seed, device)
        arrays = rgb(grey)
        self.images = {(int(p), d): Image.fromarray(a)
                       for p, d, a in zip(pats, np.tile(depths, n_pat), arrays)}

    def request(self, case: dict) -> dict:
        q = case["query"]
        neighbors = []
        for rank, (p, sim) in enumerate(zip(case["neighbors"], case["similarities"]), 1):
            rec = patient(p)
            neighbors.append({"rank": rank, "id": rec["patient_id"], "label": rec["label"],
                              "similarity": sim, "image": self.images[(p, self.neighbor_depth)]})
        req = build_audit_request(patient(q), [self.images[(q, d)] for d in self.query_depths],
                                  neighbors)
        return {"images": req["images"], "prompt": req["prompt"], "system": req["system"],
                "max_new_tokens": case["budget"]}


class Cell:
    def __init__(self, ctx):
        from emr2a_tpu_torch.judge.qwen_backend import QwenVLBackend

        cfg, mix = ctx.config, ctx.mix
        self.ctx, self.mix = ctx, mix
        ref = registry.reference(cfg["name"], ctx.root)
        state = seeded.draw(ref.weight_plan(cfg), ctx.seed, ctx.device, torch.bfloat16)
        self.backend = QwenVLBackend(config=_program_config(cfg), params=state,
                                     tokenizer=WordTokenizer(), precision=cfg["precision"],
                                     kv_dtype=cfg["kv_cache"], device=str(ctx.device))
        del state
        self.cohort = Cohort(mix, ctx.seed, ctx.device)
        self.schedule = Schedule(mix, ctx.seed)
        self.max_new = int(mix["budgets"][1])
        self._seen = []          # (ids, grids) of each prepared request, in order
        self._rows = []          # each decoded row, in order
        backend = self.backend
        prepare, decode = backend._prepare, backend._decode_row

        def traced_prepare(*args):
            with ctx.tracer.span("prepare"):
                out = prepare(*args)
            self._seen.append((list(out[0]), [tuple(g) for g in out[2]]))
            return out

        def traced_decode(row):
            self._rows.append(np.asarray(row).copy())
            return decode(row)

        backend._prepare, backend._decode_row = traced_prepare, traced_decode

    def _serve(self, requests: list) -> list:
        b = self.backend
        if self.mix["serving"] == "continuous":
            return b.generate_stream(requests, max_new_tokens=self.max_new,
                                     n_slots=int(self.mix["slots"]))
        return [b.generate(r["images"], r["prompt"], system=r["system"],
                           max_new_tokens=r["max_new_tokens"]) for r in requests]

    def warm(self) -> None:
        """The shapes the window uses: a continuous wave of ``warm_cases``
        requests (the batcher's graphs, its prefill batches and refills),
        or one request per decode length ``generate`` keeps a graph for
        (its 64-step chunks, up to the largest budget)."""
        if self.mix["serving"] == "continuous":
            cases = [self.schedule.audit_case(-1 - i) for i in range(int(self.mix["warm_cases"]))]
        else:
            cases = [dict(self.schedule.audit_case(-1), budget=b)
                     for b in range(64, self.max_new + 64, 64)]
            cases[-1]["budget"] = self.max_new
        self._serve([self.cohort.request(c) for c in cases])
        self._seen.clear()
        self._rows.clear()

    def step(self, i: int) -> dict:
        cases = self.schedule.unit(i)["cases"]
        requests = [self.cohort.request(c) for c in cases]
        first = len(self._rows)
        t0 = time.perf_counter()
        with self.ctx.tracer.span("serve"):
            texts = self._serve(requests)
        elapsed = time.perf_counter() - t0
        eos = int(self.ctx.config["eos_token_id"])
        served = []
        for case, row, (ids, grids) in zip(cases, self._rows[first:], self._seen[first:]):
            row = row[:case["budget"]].tolist()
            if eos in row:
                row = row[:row.index(eos) + 1]
            served.append({"case": case, "prompt_len": len(ids), "grids": grids,
                           "served": row})
        failed = sum(not isinstance(t, str) for t in texts) + len(cases) - len(served)
        return {"unit_index": i, "items": len(cases), "failed": failed, "seconds": elapsed,
                "requests": served,
                "shared_prefix": _shared_prefix(self._seen[first:], self.ctx.config["image_token_id"])
                if self.mix["serving"] == "continuous" else 0}

    def release(self) -> None:
        self.backend = None
        self.cohort = None


def _shared_prefix(seen: list, image_token: int) -> int:
    """The tokens every request of a wave shares before its first image
    (what the batcher prefills once a wave), 0 under 16."""
    if len(seen) < 2:
        return 0
    ids = [s[0] for s in seen]
    n = 0
    for col in zip(*ids):
        if len(set(col)) > 1 or col[0] == image_token:
            break
        n += 1
    return n if n >= 16 else 0


def build(ctx) -> Cell:
    return Cell(ctx)


def judged(ctx, records) -> list:
    """The requests the reference judges: the one with the most served
    tokens and ``judged_requests - 1`` more drawn from the seed."""
    reqs = [r for rec in records for r in rec["requests"] if r["served"]]
    if not reqs:
        return []
    longest = max(range(len(reqs)), key=lambda j: len(reqs[j]["served"]))
    others = [j for j in seeded.rng(ctx.seed, "judged").permutation(len(reqs)) if j != longest]
    return [reqs[j] for j in [longest] + others[:int(ctx.mix["judged_requests"]) - 1]]


def reference_inputs(ctx, picked: list) -> list:
    """The reference's own prompt ids and images for the picked requests:
    the chat text rendered and tokenized again, each image's tokens
    expanded to its merged grid."""
    from benchmark.inputs.audit_request import render_chat

    cfg = ctx.config
    cohort = Cohort(ctx.mix, ctx.seed, ctx.device)
    tok = WordTokenizer()
    m = cfg["vision"]["spatial_merge_size"]
    out = []
    for r in picked:
        req = cohort.request(r["case"])
        images = [np.asarray(img) for img in req["images"]]
        ids = tok(render_chat(len(images), req["prompt"], req["system"]))["input_ids"]
        expanded, k = [], 0
        for t in ids:
            if t == cfg["image_token_id"]:
                h, w = images[k].shape[0] // cfg["vision"]["patch_size"], \
                    images[k].shape[1] // cfg["vision"]["patch_size"]
                expanded += [t] * (h * w // (m * m))
                k += 1
            else:
                expanded.append(t)
        out.append({"ids": expanded, "images": images, "served": r["served"]})
    return out


def token_gaps(logits: torch.Tensor, tokens) -> torch.Tensor:
    """How far each token's logit lies below the best logit at its position."""
    tok = torch.as_tensor(tokens, device=logits.device)
    return logits.max(dim=-1).values - logits.gather(1, tok[:, None])[:, 0]


def judge(ctx, records) -> list:
    """``token_gap``: over the judged requests' served tokens, the widest
    gap by which a served token's reference logit lies below the
    reference's best at its position (the reference run teacher-forced over
    each prompt with its served tokens); ``token_gap_mean``: the mean of
    those gaps (steadier from seed to seed than the widest)."""
    picked = judged(ctx, records)
    if not picked:
        return [("judged_tokens", 0.0, -1.0)]
    ref = registry.reference(ctx.config["name"], ctx.root)
    inputs = reference_inputs(ctx, picked)
    weights = seeded.draw(ref.weight_plan(ctx.config), ctx.seed, ctx.device, torch.bfloat16)
    logits = ref.teacher_forced_logits(weights, inputs, ctx.config, ctx.device)
    del weights
    gaps = torch.cat([token_gaps(lg, r["served"]) for lg, r in zip(logits, inputs)])
    ctx.diag.update(token_flip_rate=float((gaps > 0).float().mean()),
                    token_gap_p90=float(torch.quantile(gaps, 0.9)), judged_tokens=len(gaps))
    limits = ctx.cell["limits"]
    return [("token_gap", float(gaps.max()), limits["token_gap"]),
            ("token_gap_mean", float(gaps.mean()), limits["token_gap_mean"])]
