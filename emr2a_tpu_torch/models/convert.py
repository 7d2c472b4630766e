"""Weights into the port: JAX param trees, open_clip checkpoints, and a
minimal state-dict reader.

- ``params_from_jax(tree)``: a JAX package param tree (numpy or torch
  leaves, e.g. ``BioMedCLIPImageTower`` params) -> this package's
  ``state_dict``. The layouts agree by construction (``Dense`` keeps the
  (in, out) kernel, ``Int8Dense`` the W8A8 ``kernel_q`` / ``kernel_scale``
  as they are), so the mapping only renames: ``block_i`` -> ``blocks.i``
  and a LayerNorm's ``scale`` -> ``weight``. ``params_to_jax`` is its
  inverse.
- ``convert_biomedclip_image_tower(sd)``: an open_clip BiomedCLIP state dict
  (``visual.trunk.*`` timm ViT with fused qkv, ``visual.head.proj``) -> the
  ``BioMedCLIPImageTower`` state dict. Counterpart of
  ``emr2a_tpu/models/convert.py:convert_biomedclip_image_tower``; torch's
  (out, in) weights are transposed here, once.
- ``convert_hf_bert(sd)`` and ``convert_biomedclip_text_tower(sd)``: an HF
  BERT state dict -> ``BertEncoder``'s, and open_clip BiomedCLIP's
  ``text.*`` -> ``BioMedCLIPTextTower``'s; counterparts of the JAX
  package's converters of the same names. The text tower pools the cls
  token and its proj head has no bias, so it drops the checkpoint's BERT
  pooler and any proj bias, which it never reads (the JAX converter keeps
  them, and flax ignores them).
- ``load_state_dict(path)``: safetensors or torch ``.bin`` files, or an
  HF-style directory of them, as numpy arrays.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, Mapping

import numpy as np
import torch

_TORCH_NAMES = ("pytorch_model.bin", "open_clip_pytorch_model.bin", "model.bin")
_SAFETENSOR_NAMES = ("model.safetensors",)


def _to_tensor(leaf) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":   # ml_dtypes leaves of a bf16 tree
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Flatten a JAX param tree into this package's state-dict names."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Mapping, prefix: str) -> None:
        for key, value in node.items():
            m = re.fullmatch(r"block_(\d+)", key)
            name = f"blocks.{m.group(1)}" if m else key
            if isinstance(value, Mapping):
                walk(value, f"{prefix}{name}.")
            else:
                leaf = "weight" if key == "scale" else name   # LayerNorm
                out[prefix + leaf] = _to_tensor(value)

    walk(tree, "")
    return out


def params_to_jax(state: Mapping[str, torch.Tensor]) -> Dict:
    """The inverse of ``params_from_jax``: a state dict of this package ->
    the JAX package's nested tree (leaves unchanged)."""
    tree: Dict = {}
    for key, value in state.items():
        path = []
        for part in key.split("."):
            if part.isdigit() and path and path[-1] == "blocks":
                path[-1] = f"block_{part}"
            else:
                path.append(part)
        if path[-1] == "weight":                                  # LayerNorm
            path[-1] = "scale"
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = value
    return tree


# ---------------------------------------------------------------------------
# open_clip BiomedCLIP (timm ViT trunk)
# ---------------------------------------------------------------------------

def _dense(sd, name) -> dict:
    """torch Linear -> Dense: kernel = weight.T."""
    out = {"kernel": sd[f"{name}.weight"].T}
    if f"{name}.bias" in sd:
        out["bias"] = sd[f"{name}.bias"]
    return out


def _ln(sd, name) -> dict:
    return {"scale": sd[f"{name}.weight"], "bias": sd[f"{name}.bias"]}


def _patch_conv_to_dense(weight: np.ndarray, bias=None) -> dict:
    """conv (out, C, p, p) -> Dense kernel (p*p*C, out), matching the
    (ph, pw, c) row-major patch flattening of ``models/vit.py``."""
    out = {"kernel": weight.transpose(2, 3, 1, 0).reshape(-1, weight.shape[0])}
    if bias is not None:
        out["bias"] = bias
    return out


def _timm_vit_tree(sd, num_layers: int, prefix: str) -> dict:
    tree = {
        "patch_embed": _patch_conv_to_dense(
            sd[prefix + "patch_embed.proj.weight"],
            sd.get(prefix + "patch_embed.proj.bias")),
        "cls_token": sd[prefix + "cls_token"],
        "pos_embed": sd[prefix + "pos_embed"],
        # token-pool checkpoints carry norm, global_pool="avg" ones fc_norm
        "final_ln": _ln(sd, prefix + ("norm" if prefix + "norm.weight" in sd
                                      else "fc_norm")),
    }
    for i in range(num_layers):
        p = f"{prefix}blocks.{i}."
        qkv_w = sd[p + "attn.qkv.weight"]          # (3h, h)
        h = qkv_w.shape[1]
        attn = {
            "q_proj": {"kernel": qkv_w[:h].T},
            "k_proj": {"kernel": qkv_w[h:2 * h].T},
            "v_proj": {"kernel": qkv_w[2 * h:].T},
            "out_proj": _dense(sd, p + "attn.proj"),
        }
        qkv_b = sd.get(p + "attn.qkv.bias")
        if qkv_b is not None:
            attn["q_proj"]["bias"] = qkv_b[:h]
            attn["k_proj"]["bias"] = qkv_b[h:2 * h]
            attn["v_proj"]["bias"] = qkv_b[2 * h:]
        tree[f"block_{i}"] = {
            "ln1": _ln(sd, p + "norm1"),
            "attn": attn,
            "ln2": _ln(sd, p + "norm2"),
            "mlp": {"fc1": _dense(sd, p + "mlp.fc1"),
                    "fc2": _dense(sd, p + "mlp.fc2")},
        }
    return tree


def convert_biomedclip_image_tower(sd: Mapping[str, np.ndarray],
                                   num_layers: int = 12
                                   ) -> Dict[str, torch.Tensor]:
    """open_clip BiomedCLIP state dict (numpy) -> ``BioMedCLIPImageTower``
    state dict."""
    if "visual.head.proj.weight" in sd:
        kernel = sd["visual.head.proj.weight"].T     # Linear (out, in)
    else:
        kernel = sd["visual.proj"]                   # bare (in, out) Parameter
    return params_from_jax({
        "trunk": _timm_vit_tree(sd, num_layers, prefix="visual.trunk."),
        "head_proj": {"kernel": kernel},
    })


# ---------------------------------------------------------------------------
# HF BERT and open_clip BiomedCLIP's text tower
# ---------------------------------------------------------------------------

def _hf_bert_tree(sd, num_layers: int, prefix: str) -> dict:
    e = prefix + "embeddings."
    tree = {
        "token_embed": {"embedding": sd[e + "word_embeddings.weight"]},
        "pos_embed": sd[e + "position_embeddings.weight"][None],
        "type_embed": {"embedding": sd[e + "token_type_embeddings.weight"]},
        "embed_ln": _ln(sd, e + "LayerNorm"),
    }
    for i in range(num_layers):
        p = f"{prefix}encoder.layer.{i}."
        tree[f"block_{i}"] = {
            "attn": {
                "q_proj": _dense(sd, p + "attention.self.query"),
                "k_proj": _dense(sd, p + "attention.self.key"),
                "v_proj": _dense(sd, p + "attention.self.value"),
                "out_proj": _dense(sd, p + "attention.output.dense"),
            },
            "attn_ln": _ln(sd, p + "attention.output.LayerNorm"),
            "mlp": {"fc1": _dense(sd, p + "intermediate.dense"),
                    "fc2": _dense(sd, p + "output.dense")},
            "mlp_ln": _ln(sd, p + "output.LayerNorm"),
        }
    if prefix + "pooler.dense.weight" in sd:
        tree["pooler"] = _dense(sd, prefix + "pooler.dense")
    return tree


def convert_hf_bert(sd: Mapping[str, np.ndarray], num_layers: int,
                    prefix: str = "") -> Dict[str, torch.Tensor]:
    """HF ``BertModel`` state dict (numpy) -> ``BertEncoder`` state dict
    (with ``pooler.*`` when the checkpoint has one: load it into
    ``BertEncoder(pooling="pooler")``)."""
    return params_from_jax(_hf_bert_tree(sd, num_layers, prefix))


def convert_biomedclip_text_tower(sd: Mapping[str, np.ndarray],
                                  num_layers: int = 12
                                  ) -> Dict[str, torch.Tensor]:
    """open_clip BiomedCLIP state dict (numpy) -> ``BioMedCLIPTextTower``
    state dict."""
    bert = _hf_bert_tree(sd, num_layers, prefix="text.transformer.")
    bert.pop("pooler", None)              # cls pooling never reads it
    tree = {"bert": bert}
    if "text.proj.0.weight" in sd:        # MLP proj (open_clip: bias-free)
        tree["proj_fc1"] = {"kernel": sd["text.proj.0.weight"].T}
        tree["proj_fc2"] = {"kernel": sd["text.proj.2.weight"].T}
    elif "text.proj.weight" in sd:
        tree["proj"] = {"kernel": sd["text.proj.weight"].T}
    elif "text.proj" in sd:
        tree["proj"] = {"kernel": sd["text.proj"]}
    return params_from_jax(tree)


# ---------------------------------------------------------------------------
# state-dict files
# ---------------------------------------------------------------------------

def load_state_dict(model_path) -> Dict[str, np.ndarray]:
    """A torch / safetensors state dict from a file or HF-style directory,
    as numpy arrays."""
    path = Path(model_path)
    if path.is_dir():
        for name in _SAFETENSOR_NAMES:
            if (path / name).exists():
                return _load_safetensors(path / name)
        shards = sorted(path.glob("*.safetensors"))
        if shards:
            out: Dict[str, np.ndarray] = {}
            for s in shards:
                out.update(_load_safetensors(s))
            return out
        for name in _TORCH_NAMES:
            if (path / name).exists():
                return _load_torch(path / name)
        raise FileNotFoundError(f"No checkpoint file found under {path}")
    if path.suffix == ".safetensors":
        return _load_safetensors(path)
    return _load_torch(path)


def _load_safetensors(path: Path) -> Dict[str, np.ndarray]:
    from safetensors.torch import load_file
    return {k: v.float().numpy() if v.dtype == torch.bfloat16 else v.numpy()
            for k, v in load_file(str(path)).items()}


def _load_torch(path: Path) -> Dict[str, np.ndarray]:
    sd = torch.load(str(path), map_location="cpu", weights_only=True)
    for wrapper in ("state_dict", "model", "model_state", "model_state_dict"):
        if isinstance(sd, dict) and wrapper in sd and isinstance(sd[wrapper], dict):
            sd = sd[wrapper]
            break
    return {k: (v.float() if v.dtype == torch.bfloat16 else v).numpy()
            for k, v in sd.items() if isinstance(v, torch.Tensor)}
