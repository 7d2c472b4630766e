"""Post-load W8A8 quantization of transformer tower params, in numpy.

Port of ``emr2a_tpu/models/quantize.py`` (``quantize_block_params``,
``quantize_tower_params``, ``quantize_params_tree``), on the JAX package's
nested param trees and names: each TransformerBlock's projection and MLP
kernels become ``kernel_q`` (int8, (in, out)) and ``kernel_scale`` (f32,
(out,)) from ``ops/mlp.quantize_weight_int8``; everything else passes
through. The trees are byte-identical to the JAX package's. Leaves may be
numpy arrays (ml_dtypes bfloat16 included) or torch tensors.

``models/layers.load_params`` routes the quantized entries to the W8A8 ops.

``quantize_qwen_text_params`` (int8 and int4 decoder layers, ``fuse_projs``,
``lm_head_int8``) is ``emr2a_tpu/models/quantize.py:122-175``: numpy leaves
take the JAX package's numpy recipes and give byte-identical trees; torch
leaves take the recipes' torch twins on their own device
(``quantize_weight_int8_torch``, ``ops/linear_int4.quantize_weight_int4_torch``),
which give the same bytes. The 8B's decoder weights are quantized on the card
that way; numpy on the host would take minutes.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from emr2a_tpu_torch.ops.linear_int4 import (
    int4_group,
    quantize_weight_int4,
    quantize_weight_int4_torch,
)
from emr2a_tpu_torch.ops.mlp import quantize_weight_int8

_ATTN_PROJS = ("q_proj", "k_proj", "v_proj", "out_proj",
               "o_proj")                                    # DINOv3 naming
_MLP_FCS = ("fc1", "fc2",
            "gate_proj", "up_proj", "down_proj")            # DINOv3 naming


def _f32(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().float().numpy()
    return np.asarray(leaf, np.float32)


def quantize_weight_int8_torch(w: torch.Tensor):
    """``ops/mlp.quantize_weight_int8`` on ``w``'s device, in torch: the same
    codes and scales (true divisions by tensors, the 1e-12 floor after the
    division by 127, round half to even)."""
    w = w.float()
    amax = w.abs().amax(dim=0, keepdim=True)
    scale = torch.clamp(amax / torch.full_like(amax, 127.0), min=1e-12)
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale


def _quantize_dense(entry: Dict) -> Dict:
    q, scale = quantize_weight_int8(_f32(entry["kernel"]))
    out = {k: v for k, v in entry.items() if k != "kernel"}
    out["kernel_q"] = q
    out["kernel_scale"] = scale.reshape(-1)
    return out


def quantize_block_params(block: Dict) -> Dict:
    """One TransformerBlock subtree -> W8A8 subtree."""
    out = dict(block)
    if "attn" in block:
        attn = dict(block["attn"])
        for proj in _ATTN_PROJS:
            if proj in attn and "kernel" in attn[proj]:
                attn[proj] = _quantize_dense(attn[proj])
        out["attn"] = attn
    if "mlp" in block:
        mlp = dict(block["mlp"])
        for fc in _MLP_FCS:
            if fc in mlp and "kernel" in mlp[fc]:
                mlp[fc] = _quantize_dense(mlp[fc])
        out["mlp"] = mlp
    return out


def quantize_tower_params(params: Dict) -> Dict:
    """Tower params -> params with every ``block_i`` quantized; the other
    entries (patch embed, position embeddings, LayerNorms, heads) pass
    through untouched."""
    return {name: (quantize_block_params(sub)
                   if name.startswith("block_") else sub)
            for name, sub in params.items()}


def quantize_params_tree(params):
    """Quantize every tower level anywhere in a param tree (any dict level
    with a ``block_*`` key); everything else passes through."""
    if not isinstance(params, dict):
        return params
    if any(k.startswith("block_") for k in params):
        return quantize_tower_params(params)
    return {k: quantize_params_tree(v) for k, v in params.items()}


_QWEN_PROJS = ("q_proj", "k_proj", "v_proj", "o_proj",
               "gate_proj", "up_proj", "down_proj")


def _quantize_dense_int8(entry: Dict) -> Dict:
    """``_quantize_dense``, on the kernel's own device for a torch leaf."""
    kernel = entry["kernel"]
    if not isinstance(kernel, torch.Tensor):
        return _quantize_dense(entry)
    q, scale = quantize_weight_int8_torch(kernel)
    out = {k: v for k, v in entry.items() if k != "kernel"}
    out["kernel_q"] = q
    out["kernel_scale"] = scale.reshape(-1)
    return out


def _quantize_dense_int4(entry: Dict) -> Dict:
    kernel = entry["kernel"]
    group = int4_group(kernel.shape[0])
    if isinstance(kernel, torch.Tensor):
        packed, scale = quantize_weight_int4_torch(kernel, group=group)
    else:
        packed, scale = quantize_weight_int4(_f32(kernel), group=group)
    out = {k: v for k, v in entry.items() if k != "kernel"}
    out["kernel_p4"] = packed
    out["kernel_scale4"] = scale
    return out


def _fuse_entries(layer: Dict, names) -> Dict:
    """Concatenate projection kernels (and biases, if all have one) along
    the output axis: one kernel launch and one activation quantize instead
    of len(names). Column scales are per output column, so quantizing the
    concatenation equals quantizing the parts."""
    kernels = [layer[n]["kernel"] for n in names]
    if isinstance(kernels[0], torch.Tensor):
        entry = {"kernel": torch.cat([k.float() for k in kernels], dim=1)}
        if all("bias" in layer[n] for n in names):
            entry["bias"] = torch.cat([layer[n]["bias"] for n in names])
        return entry
    entry = {"kernel": np.concatenate([_f32(k) for k in kernels], axis=1)}
    if all("bias" in layer[n] for n in names):
        entry["bias"] = np.concatenate([_f32(layer[n]["bias"]) for n in names])
    return entry


def quantize_qwen_text_params(params: Dict, lm_head_int8: bool = False,
                              precision: str = "int8",
                              fuse_projs: bool = False) -> Dict:
    """Qwen text-model params (the JAX package's tree) -> W8A8 or W4A8
    decoder layers: the seven projections of every ``layer_i`` become
    ``kernel_q`` / ``kernel_scale`` (int8) or ``kernel_p4`` /
    ``kernel_scale4`` (int4, group 128 at real widths). ``fuse_projs``
    merges q/k/v and gate/up into ``qkv_proj`` / ``gate_up_proj``. The
    embedding, the norms and the lm_head stay as they are, unless
    ``lm_head_int8``."""
    if precision not in ("int8", "int4"):
        raise ValueError(f"precision must be int8|int4, got {precision!r}")
    quant = _quantize_dense_int8 if precision == "int8" else _quantize_dense_int4

    def one_layer(layer: Dict) -> Dict:
        out = dict(layer)
        fused = set()
        if fuse_projs:
            qkv = ("q_proj", "k_proj", "v_proj")
            if all(p in layer and "kernel" in layer[p] for p in qkv):
                out["qkv_proj"] = quant(_fuse_entries(layer, qkv))
                fused.update(qkv)
            gu = ("gate_proj", "up_proj")
            if all(p in layer and "kernel" in layer[p] for p in gu):
                out["gate_up_proj"] = quant(_fuse_entries(layer, gu))
                fused.update(gu)
            for p in fused:
                del out[p]
        for proj in _QWEN_PROJS:
            if proj not in fused and proj in layer and "kernel" in layer[proj]:
                out[proj] = quant(layer[proj])
        return out

    out = {name: (one_layer(sub) if name.startswith("layer_") else sub)
           for name, sub in params.items()}
    if lm_head_int8 and "lm_head" in out and "kernel" in out["lm_head"]:
        out["lm_head"] = _quantize_dense_int8(out["lm_head"])
    return out
