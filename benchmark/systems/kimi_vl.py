"""Kimi-VL's cells: step4's audit of a CV fold's predictions, through the
program's judge backend ``KimiVLBackend``: continuous serving
(``generate_stream`` over ``slots`` slots, a unit a wave of requests) or
one request at a time (``generate``), greedy.

Everything but the backend and the chat text is ``systems/qwen3_vl.py``'s:
the cohort's requests (``Cohort``), the unit's loop (``Cell``), the judged
requests (``judged``) and their gaps (``token_gaps``). Weights come from
the reference's plan, drawn on the device from the seed and handed to the
backend as its state dict. The configuration's ``precision`` "int8" (the
control) rounds every kernel of the drawn weights through int8 per output
channel before the backend takes them: the program runs in bf16 on
weights that lost what int8 loses.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from benchmark.core import registry, seeded
from benchmark.inputs.kimi_chat import KimiWordTokenizer, render_chat
# imported here, so that a program without this backend fails at once
from emr2a_tpu_torch.judge.kimi_backend import KimiVLBackend

qwen = registry.system("qwen3_vl")


def program_config(cfg: dict):
    """The program's ``KimiVLConfig`` from the configuration's file."""
    from emr2a_tpu_torch.models.kimi_vl import KimiTextConfig, KimiVLConfig, moonvit_config

    v = cfg["vision_config"]
    vision = replace(moonvit_config(torch.bfloat16), depth=v["num_hidden_layers"],
                     hidden_size=v["hidden_size"], intermediate_size=v["intermediate_size"],
                     num_heads=v["num_attention_heads"], patch_size=v["patch_size"],
                     spatial_merge_size=v["merge_kernel_size"][0],
                     out_hidden_size=cfg["hidden_size"],
                     num_position_embeddings=v["init_pos_emb_height"] * v["init_pos_emb_width"])
    text = KimiTextConfig(
        vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"],
        num_layers=cfg["num_hidden_layers"], num_heads=cfg["num_attention_heads"],
        kv_lora_rank=cfg["kv_lora_rank"], qk_nope_head_dim=cfg["qk_nope_head_dim"],
        qk_rope_head_dim=cfg["qk_rope_head_dim"], v_head_dim=cfg["v_head_dim"],
        intermediate_size=cfg["intermediate_size"],
        moe_intermediate_size=cfg["moe_intermediate_size"],
        n_routed_experts=cfg["n_routed_experts"], n_shared_experts=cfg["n_shared_experts"],
        num_experts_per_tok=cfg["num_experts_per_tok"],
        first_k_dense_replace=cfg["first_k_dense_replace"],
        routed_scaling_factor=cfg["routed_scaling_factor"], rms_norm_eps=cfg["rms_norm_eps"],
        rope_theta=float(cfg["rope_theta"]), dtype=torch.bfloat16)
    return KimiVLConfig(vision=vision, text=text, image_token_id=cfg["image_token_id"])


def _is_kernel(name: str) -> bool:
    return name.endswith((".kernel", "experts_gate_up", "experts_down"))


@torch.no_grad()
def round_int8(state: dict) -> None:
    """Every kernel rounded through int8 per output channel (its last
    dimension), in place."""
    for name, w in state.items():
        if _is_kernel(name):
            scale = w.float().abs().amax(dim=-2, keepdim=True).clamp(min=1e-8) / 127
            w.copy_(torch.round(w.float() / scale).clamp(-127, 127) * scale)


class Cell(qwen.Cell):
    def __init__(self, ctx):
        cfg, mix = ctx.config, ctx.mix
        self.ctx, self.mix = ctx, mix
        ref = registry.reference(cfg["name"], ctx.root)
        state = seeded.draw(ref.weight_plan(cfg), ctx.seed, ctx.device, torch.bfloat16)
        if cfg["precision"] == "int8":
            round_int8(state)
        elif cfg["precision"] != "bf16":
            raise ValueError(f"precision {cfg['precision']!r}: bf16, or int8 for the control")
        self.backend = KimiVLBackend(config=program_config(cfg), params=state,
                                     tokenizer=KimiWordTokenizer(), kv_dtype=cfg["kv_cache"],
                                     record_routes=True)
        del state
        self.cohort = qwen.Cohort(mix, ctx.seed, ctx.device)
        self.schedule = qwen.Schedule(mix, ctx.seed)
        self.max_new = int(mix["budgets"][1])
        self._seen, self._rows = [], []
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

    def step(self, i: int) -> dict:
        """The unit as ``systems/qwen3_vl``'s, each served request with the
        expert choices the program made at its positions (the batcher's
        ``records``, on the device) and the batcher's prompt bucket."""
        out = super().step(i)
        batcher = next((b for b in self.backend._batchers.values() if b._state is not None),
                       None)
        for j, req in enumerate(out["requests"]):
            req["routes"] = None if batcher is None else batcher.records.get(j)
            req["bucket"] = None if batcher is None else batcher.prompt_bucket
        return out


def build(ctx) -> Cell:
    return Cell(ctx)


def reference_inputs(ctx, picked: list) -> list:
    """The reference's own prompt ids and images: the chat text rendered and
    tokenized again, each placeholder expanded to its image's merged
    tokens."""
    cfg = ctx.config
    v = cfg["vision_config"]
    per = v["patch_size"] * v["merge_kernel_size"][0]
    cohort = qwen.Cohort(ctx.mix, ctx.seed, ctx.device)
    tok = KimiWordTokenizer()
    out = []
    for r in picked:
        req = cohort.request(r["case"])
        images = [np.asarray(img) for img in req["images"]]
        ids = tok(render_chat(len(images), req["prompt"], req["system"]))["input_ids"]
        expanded, k = [], 0
        for t in ids:
            if t == cfg["image_token_id"]:
                h, w = images[k].shape[:2]
                expanded += [t] * ((h // per) * (w // per))
                k += 1
            else:
                expanded.append(t)
        out.append({"ids": expanded, "images": images, "served": r["served"]})
    return out


def program_routes(r: dict, length: int) -> torch.Tensor:
    """The program's expert choices at each position of the reference's
    sequence (the prompt, then the served tokens but the last), (expert
    layers, ``length``, top_k), from the request's slot records: the prompt
    at its own rows, each decoded token's row (the batcher's ring past the
    bucket) found by its recorded position."""
    rec, tl = r["routes"], r["prompt_len"]
    if rec is None:
        raise ValueError("the program kept no route records for a judged request "
                         "(the continuous batcher of a model that records them keeps them)")
    rec = rec.to(torch.int64)
    layers, top_k = rec.shape[0], rec.shape[-1] - 1
    out = torch.full((layers, length, top_k), -1, dtype=torch.int64, device=rec.device)
    head = rec[:, :tl]
    if not torch.equal(head[..., 0], torch.arange(1, tl + 1, device=rec.device).expand(layers, -1)):
        raise ValueError("the route records' prompt rows do not hold the prompt's positions")
    out[:, :tl] = head[..., 1:]
    ring = rec[:, r["bucket"]:]
    pos = ring[..., 0] - 1
    keep = (pos >= tl) & (pos < length)
    layer = torch.arange(layers, device=rec.device)[:, None].expand_as(pos)
    out[layer[keep], pos[keep]] = ring[..., 1:][keep]
    if (out < 0).any():
        raise ValueError(f"the route records miss {int((out[..., 0] < 0).sum())} of "
                         f"{layers * length} (layer, position) choices")
    return out


def judge(ctx, records) -> list:
    """Over the judged requests' served tokens, against this configuration's
    reference run teacher-forced with the program's own expert choices:

    - ``route_margin``: the widest by which the reference's best score +
      bias left out exceeds the least the program took, over every expert
      layer and position (0 where the program took the reference's own top
      6). Routing is discrete: bf16 rounding moves the scores of near ties
      past each other, and at full depth with random weights such flips
      compound; following the program's choices keeps the comparison on
      what each choice computes, and this number holds the choices
      themselves to the reference's scores.
    - ``token_gap`` and ``token_gap_mean`` as ``systems/qwen3_vl.judge``
      sets them out.
    """
    picked = qwen.judged(ctx, records)
    if not picked:
        return [("judged_tokens", 0.0, -1.0)]
    ref = registry.reference(ctx.config["name"], ctx.root)
    inputs = reference_inputs(ctx, picked)
    for inp, r in zip(inputs, picked):
        if len(inp["ids"]) != r["prompt_len"]:
            raise ValueError(f"the reference's prompt has {len(inp['ids'])} tokens, the "
                             f"program's {r['prompt_len']}")
        inp["routes"] = program_routes(r, len(inp["ids"]) + len(r["served"]) - 1)
    weights = seeded.draw(ref.weight_plan(ctx.config), ctx.seed, ctx.device, torch.bfloat16)
    stats = {}
    logits = ref.teacher_forced_logits(weights, inputs, ctx.config, ctx.device, stats)
    del weights
    gaps = torch.cat([qwen.token_gaps(lg, r["served"]) for lg, r in zip(logits, inputs)])
    ctx.diag.update(token_flip_rate=float((gaps > 0).float().mean()),
                    token_gap_p90=float(torch.quantile(gaps, 0.9)), judged_tokens=len(gaps),
                    route_swap_share=stats["swapped"] / stats["decisions"])
    limits = ctx.cell["limits"]
    return [("route_margin", stats["margin"], limits["route_margin"]),
            ("token_gap", float(gaps.max()), limits["token_gap"]),
            ("token_gap_mean", float(gaps.mean()), limits["token_gap_mean"])]
