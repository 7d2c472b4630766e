"""Write a Qwen3-VL checkpoint directory from a state dict of this package:
``config.json`` and ``model.safetensors`` in Hugging Face's names and
layout (``Qwen3VLForConditionalGeneration``), the inverse of
``models/qwen3_vl.convert_hf_qwen3_vl`` and ``qwen3_vl_config_from_hf``.
Runs on the card's machine, which has neither ``transformers`` nor
``safetensors``, so that the CLIs' ``--model_path`` route can be driven
from seeded weights there (``models/checkpoint.load_qwen3_vl`` reads the
directory back).

    from emr2a_tpu_torch.tools.qwen_checkpoint import write_checkpoint
    write_checkpoint(path, config, state)
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Mapping

import torch

_DTYPES = {torch.bfloat16: "BF16", torch.float16: "F16", torch.float32: "F32",
           torch.int8: "I8", torch.int64: "I64"}


def hf_config(config) -> dict:
    """The ``config.json`` of a ``Qwen3VLConfig`` (the keys
    ``qwen3_vl_config_from_hf`` reads, under Hugging Face's names)."""
    v, t = config.vision, config.text
    return {
        "architectures": ["Qwen3VLForConditionalGeneration"],
        "model_type": "qwen3_vl",
        "image_token_id": config.image_token_id,
        "video_token_id": config.video_token_id,
        "vision_start_token_id": config.vision_start_token_id,
        "tie_word_embeddings": t.tie_word_embeddings,
        "vision_config": {
            "model_type": "qwen3_vl", "depth": v.depth, "hidden_size": v.hidden_size,
            "intermediate_size": v.intermediate_size, "num_heads": v.num_heads,
            "in_channels": v.in_channels, "patch_size": v.patch_size,
            "temporal_patch_size": v.temporal_patch_size,
            "spatial_merge_size": v.spatial_merge_size,
            "out_hidden_size": v.out_hidden_size,
            "num_position_embeddings": v.num_position_embeddings,
            "deepstack_visual_indexes": list(v.deepstack_visual_indexes),
            "hidden_act": v.hidden_act},
        "text_config": {
            "model_type": "qwen3_vl_text", "vocab_size": t.vocab_size,
            "hidden_size": t.hidden_size, "num_hidden_layers": t.num_layers,
            "num_attention_heads": t.num_heads, "num_key_value_heads": t.num_kv_heads,
            "head_dim": t.head_dim, "intermediate_size": t.intermediate_size,
            "rms_norm_eps": t.rms_norm_eps, "rope_theta": t.rope_theta,
            "rope_scaling": {"rope_type": "default", "mrope_section": list(t.mrope_section)},
            "attention_bias": t.attention_bias, "hidden_act": t.hidden_act,
            "tie_word_embeddings": t.tie_word_embeddings},
    }


def to_hf_state(config, state: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A ``Qwen3VLModel`` state dict -> Hugging Face's names and layouts
    (torch (out, in) weights, the fused qkv, the patch embed as a conv)."""
    v = config.vision
    vp, tp = "model.visual.", "model.language_model."
    out: Dict[str, torch.Tensor] = {}

    def dense(hf: str, port: str) -> None:
        out[hf + ".weight"] = state[port + ".kernel"].t().contiguous()
        if port + ".bias" in state:
            out[hf + ".bias"] = state[port + ".bias"]

    def norm(hf: str, port: str) -> None:
        out[hf + ".weight"] = state[port + ".weight"]
        if port + ".bias" in state:
            out[hf + ".bias"] = state[port + ".bias"]

    def merger(hf: str, port: str) -> None:
        norm(hf + "norm", port + "norm")
        dense(hf + "linear_fc1", port + "fc1")
        dense(hf + "linear_fc2", port + "fc2")

    kernel = state["visual.patch_embed.kernel"]
    out[vp + "patch_embed.proj.weight"] = kernel.t().reshape(
        v.hidden_size, v.in_channels, v.temporal_patch_size, v.patch_size,
        v.patch_size).contiguous()
    out[vp + "patch_embed.proj.bias"] = state["visual.patch_embed.bias"]
    out[vp + "pos_embed.weight"] = state["visual.pos_embed"]
    merger(vp + "merger.", "visual.merger.")
    for j in range(len(v.deepstack_visual_indexes)):
        merger(vp + f"deepstack_merger_list.{j}.", f"visual.deepstack_mergers.{j}.")
    for i in range(v.depth):
        b, p = vp + f"blocks.{i}.", f"visual.blocks.{i}."
        norm(b + "norm1", p + "norm1")
        norm(b + "norm2", p + "norm2")
        out[b + "attn.qkv.weight"] = torch.cat(
            [state[p + f"{n}_proj.kernel"].t() for n in "qkv"]).contiguous()
        if p + "q_proj.bias" in state:
            out[b + "attn.qkv.bias"] = torch.cat([state[p + f"{n}_proj.bias"] for n in "qkv"])
        dense(b + "attn.proj", p + "o_proj")
        dense(b + "mlp.linear_fc1", p + "fc1")
        dense(b + "mlp.linear_fc2", p + "fc2")
    lm = "language_model."
    out[tp + "embed_tokens.weight"] = state[lm + "embed_tokens.embedding"]
    out[tp + "norm.weight"] = state[lm + "final_ln.weight"]
    for i in range(config.text.num_layers):
        b, p = tp + f"layers.{i}.", lm + f"layers.{i}."
        out[b + "input_layernorm.weight"] = state[p + "input_ln.weight"]
        out[b + "post_attention_layernorm.weight"] = state[p + "post_ln.weight"]
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            dense(b + "self_attn." + name, p + name)
        out[b + "self_attn.q_norm.weight"] = state[p + "q_norm_scale"]
        out[b + "self_attn.k_norm.weight"] = state[p + "k_norm_scale"]
        for name in ("gate_proj", "up_proj", "down_proj"):
            dense(b + "mlp." + name, p + name)
    if lm + "lm_head.kernel" in state:
        out["lm_head.weight"] = state[lm + "lm_head.kernel"].t().contiguous()
    return out


def write_safetensors(path, tensors: Mapping[str, torch.Tensor]) -> None:
    """A ``.safetensors`` file: the 8-byte little-endian header length, the
    JSON header (padded with spaces to a multiple of 8), then each tensor's
    bytes in header order."""
    header, offset = {}, 0
    parts = []
    for name, t in tensors.items():
        t = t.detach().contiguous().cpu()
        raw = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tobytes()
        header[name] = {"dtype": _DTYPES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        offset += len(raw)
        parts.append(raw)
    blob = json.dumps(header).encode()
    blob += b" " * (-len(blob) % 8)
    with Path(path).open("wb") as f:
        f.write(len(blob).to_bytes(8, "little"))
        f.write(blob)
        for raw in parts:
            f.write(raw)


def write_checkpoint(path, config, state: Mapping[str, torch.Tensor]) -> Path:
    """``config.json`` and ``model.safetensors`` of ``(config, state)`` under
    ``path`` (created); returns the directory."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(json.dumps(hf_config(config), indent=1))
    write_safetensors(path / "model.safetensors", to_hf_state(config, state))
    return path
