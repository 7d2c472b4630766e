"""Weights into the port: JAX param trees, open_clip checkpoints, and a
minimal state-dict reader.

- ``params_from_jax(tree)``: a JAX package param tree (numpy or torch
  leaves, e.g. ``BioMedCLIPImageTower`` params) -> this package's
  ``state_dict``. The layouts agree by construction (``Dense`` keeps the
  (in, out) kernel, ``Int8Dense`` the W8A8 ``kernel_q`` / ``kernel_scale``
  as they are), so the mapping only renames: ``block_i`` -> ``blocks.i``
  and a LayerNorm's ``scale`` -> ``weight``. ``params_to_jax`` is its
  inverse.
- ``convert_timm_vit(sd)`` and ``convert_hf_vit(sd)``: a timm ViT (fused
  qkv) or an HF ``ViTModel`` state dict -> the ``VisionTransformer`` state
  dict; ``convert_hf_clip_vision`` / ``convert_hf_clip_text`` and
  ``convert_hf_clip_image_tower`` / ``convert_hf_clip_text_tower``: an HF
  ``CLIPModel`` state dict -> ``VisionTransformer`` /
  ``CLIPTextTransformer`` and ``CLIPImageTower`` / ``CLIPTextTower`` state
  dicts. Counterparts of the JAX package's converters of the same names
  (``emr2a_tpu/models/convert.py:55-200``); DINOv3's is
  ``models/dinov3.convert_hf_dinov3``.
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
  HF-style directory of them (sharded or not), as numpy arrays. Safetensors
  are read by this module's own reader (``read_safetensors``: the 8-byte
  header length, the JSON header, one ``torch.frombuffer`` per tensor), so
  no ``safetensors`` package is needed.
- The Qwen3-VL tree (``models/qwen3_vl.convert_hf_qwen3_vl``) maps the same
  way, with ``layer_i`` -> ``layers.i`` and ``deepstack_merger_j`` ->
  ``deepstack_mergers.j``.
- ``convert_torch_resnet18(sd)``: a torchvision ``resnet18`` state dict ->
  ``models/resnet.ResNet18``'s (the CNN baseline's ``--pretrained_path``);
  ``resnet_from_jax(variables)``: the JAX package's flax ResNet variables
  -> the port's ResNet state dicts (conv and dense kernels transposed to
  torch's layouts).
- ``bringup_qwen3_vl`` and its CLI (``python -m
  emr2a_tpu_torch.models.convert --qwen3-vl DIR [--device cpu]``): load a
  Qwen3-VL checkpoint, run its encoder taps, a text embedding and a short
  greedy generation, then a tokenizer round trip.
"""

from __future__ import annotations

import json
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


# JAX module-list names -> this package's nn.ModuleList names
_LISTS = (("block", "blocks"), ("layer", "layers"),
          ("deepstack_merger", "deepstack_mergers"))


def params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Flatten a JAX param tree into this package's state-dict names."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Mapping, prefix: str) -> None:
        for key, value in node.items():
            name = key
            for jax_name, torch_name in _LISTS:
                m = re.fullmatch(rf"{jax_name}_(\d+)", key)
                if m:
                    name = f"{torch_name}.{m.group(1)}"
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
        lists = {torch_name: jax_name for jax_name, torch_name in _LISTS}
        for part in key.split("."):
            if part.isdigit() and path and path[-1] in lists:
                path[-1] = f"{lists[path[-1]]}_{part}"
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


def convert_timm_vit(sd: Mapping[str, np.ndarray], num_layers: int,
                     prefix: str = "") -> Dict[str, torch.Tensor]:
    """timm ViT state dict (numpy) -> ``VisionTransformer`` state dict."""
    return params_from_jax(_timm_vit_tree(sd, num_layers, prefix))


def _hf_vit_tree(sd, num_layers: int, prefix: str) -> dict:
    e = prefix + "embeddings."
    tree = {
        "patch_embed": _patch_conv_to_dense(
            sd[e + "patch_embeddings.projection.weight"],
            sd.get(e + "patch_embeddings.projection.bias")),
        "cls_token": sd[e + "cls_token"],
        "pos_embed": sd[e + "position_embeddings"],
        "final_ln": _ln(sd, prefix + "layernorm"),
    }
    for i in range(num_layers):
        p = f"{prefix}encoder.layer.{i}."
        tree[f"block_{i}"] = {
            "ln1": _ln(sd, p + "layernorm_before"),
            "attn": {
                "q_proj": _dense(sd, p + "attention.attention.query"),
                "k_proj": _dense(sd, p + "attention.attention.key"),
                "v_proj": _dense(sd, p + "attention.attention.value"),
                "out_proj": _dense(sd, p + "attention.output.dense"),
            },
            "ln2": _ln(sd, p + "layernorm_after"),
            "mlp": {"fc1": _dense(sd, p + "intermediate.dense"),
                    "fc2": _dense(sd, p + "output.dense")},
        }
    return tree


def convert_hf_vit(sd: Mapping[str, np.ndarray], num_layers: int,
                   prefix: str = "") -> Dict[str, torch.Tensor]:
    """HF ``ViTModel`` state dict (numpy) -> ``VisionTransformer`` state
    dict."""
    return params_from_jax(_hf_vit_tree(sd, num_layers, prefix))


# ---------------------------------------------------------------------------
# HF CLIP
# ---------------------------------------------------------------------------

def _clip_encoder_layers(sd, prefix: str, num_layers: int) -> dict:
    blocks = {}
    for i in range(num_layers):
        p = f"{prefix}encoder.layers.{i}."
        blocks[f"block_{i}"] = {
            "ln1": _ln(sd, p + "layer_norm1"),
            "attn": {
                "q_proj": _dense(sd, p + "self_attn.q_proj"),
                "k_proj": _dense(sd, p + "self_attn.k_proj"),
                "v_proj": _dense(sd, p + "self_attn.v_proj"),
                "out_proj": _dense(sd, p + "self_attn.out_proj"),
            },
            "ln2": _ln(sd, p + "layer_norm2"),
            "mlp": {"fc1": _dense(sd, p + "mlp.fc1"),
                    "fc2": _dense(sd, p + "mlp.fc2")},
        }
    return blocks


def _hf_clip_vision_tree(sd, num_layers: int, prefix: str) -> dict:
    e = prefix + "embeddings."
    tree = {
        "patch_embed": _patch_conv_to_dense(sd[e + "patch_embedding.weight"]),
        "cls_token": sd[e + "class_embedding"].reshape(1, 1, -1),
        "pos_embed": sd[e + "position_embedding.weight"][None],
        # HF's attribute is the typo'd "pre_layrnorm"
        "pre_ln": _ln(sd, prefix + ("pre_layrnorm" if prefix + "pre_layrnorm.weight" in sd
                                    else "pre_layernorm")),
        "final_ln": _ln(sd, prefix + "post_layernorm"),
    }
    tree.update(_clip_encoder_layers(sd, prefix, num_layers))
    return tree


def _hf_clip_text_tree(sd, num_layers: int, prefix: str) -> dict:
    e = prefix + "embeddings."
    tree = {
        "token_embed": {"embedding": sd[e + "token_embedding.weight"]},
        "pos_embed": sd[e + "position_embedding.weight"][None],
        "final_ln": _ln(sd, prefix + "final_layer_norm"),
    }
    tree.update(_clip_encoder_layers(sd, prefix, num_layers))
    return tree


def convert_hf_clip_vision(sd: Mapping[str, np.ndarray], num_layers: int,
                           prefix: str = "vision_model.") -> Dict[str, torch.Tensor]:
    """HF ``CLIPVisionTransformer`` -> ``VisionTransformer`` state dict."""
    return params_from_jax(_hf_clip_vision_tree(sd, num_layers, prefix))


def convert_hf_clip_text(sd: Mapping[str, np.ndarray], num_layers: int,
                         prefix: str = "text_model.") -> Dict[str, torch.Tensor]:
    """HF ``CLIPTextTransformer`` -> ``CLIPTextTransformer`` state dict."""
    return params_from_jax(_hf_clip_text_tree(sd, num_layers, prefix))


def convert_hf_clip_image_tower(sd: Mapping[str, np.ndarray],
                                num_layers: int) -> Dict[str, torch.Tensor]:
    """HF ``CLIPModel`` state dict -> ``CLIPImageTower`` state dict."""
    return params_from_jax({
        "vision": _hf_clip_vision_tree(sd, num_layers, "vision_model."),
        "visual_projection": {"kernel": sd["visual_projection.weight"].T},
    })


def convert_hf_clip_text_tower(sd: Mapping[str, np.ndarray],
                               num_layers: int) -> Dict[str, torch.Tensor]:
    """HF ``CLIPModel`` state dict -> ``CLIPTextTower`` state dict."""
    return params_from_jax({
        "text": _hf_clip_text_tree(sd, num_layers, "text_model."),
        "text_projection": {"kernel": sd["text_projection.weight"].T},
    })


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
# ResNet-18 (CNN baseline backbone)
# ---------------------------------------------------------------------------

def convert_torch_resnet18(sd: Mapping[str, np.ndarray],
                           prefix: str = "") -> Dict[str, torch.Tensor]:
    """torchvision ``resnet18`` state dict -> the state dict of
    ``models/resnet.ResNet18`` (the backbone: ``fc.*`` is dropped, as the
    baseline heads train from scratch; ``num_batches_tracked`` is ignored).
    Counterpart of ``emr2a_tpu/models/convert.py:convert_torch_resnet18``,
    whose layouts need no transpose here: both sides are torch's."""
    names = {"conv1": "stem_conv", "bn1": "stem_bn"}
    for stage, n_blocks in enumerate((2, 2, 2, 2)):
        for block in range(n_blocks):
            src, dst = f"layer{stage + 1}.{block}.", f"stage{stage}_block{block}."
            for part in ("conv1", "bn1", "conv2", "bn2"):
                names[src + part] = dst + part
            names[src + "downsample.0"] = dst + "downsample_conv"
            names[src + "downsample.1"] = dst + "downsample_bn"
    out: Dict[str, torch.Tensor] = {}
    for src, dst in names.items():
        if f"{prefix}{src}.weight" not in sd:
            continue                            # a block without downsample
        leaves = (("weight",) if "conv" in dst
                  else ("weight", "bias", "running_mean", "running_var"))
        for leaf in leaves:
            out[f"{dst}.{leaf}"] = _to_tensor(sd[f"{prefix}{src}.{leaf}"])
    return out


def resnet_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """Flax ``{"params", "batch_stats"}`` of the JAX package's ResNet18,
    ``ImageOnlyModel`` or ``MultimodalModel`` (numpy leaves) -> the state
    dict of the port's module of the same name: a Conv kernel (kh, kw, in,
    out) becomes (out, in, kh, kw), a Dense kernel (in, out) becomes (out,
    in), BatchNorm's scale / bias / mean / var become weight, bias and the
    running buffers."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Mapping, prefix: str, stats: bool) -> None:
        for key, value in node.items():
            if isinstance(value, Mapping):
                walk(value, f"{prefix}{key}.", stats)
                continue
            t = _to_tensor(value)
            if stats:
                name = {"mean": "running_mean", "var": "running_var"}[key]
            elif key == "kernel":
                name, t = "weight", (t.permute(3, 2, 0, 1) if t.dim() == 4 else t.T)
            else:
                name = {"scale": "weight", "bias": "bias"}[key]
            out[prefix + name] = t.contiguous()

    walk(variables["params"], "", False)
    walk(variables.get("batch_stats", {}), "", True)
    return out


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


_SAFETENSORS_DTYPES = {"BF16": torch.bfloat16, "F16": torch.float16,
                       "F32": torch.float32, "I8": torch.int8,
                       "I64": torch.int64}


def read_safetensors(path) -> Dict[str, torch.Tensor]:
    """A ``.safetensors`` file as torch tensors, without the safetensors
    package: an 8-byte little-endian header length, a JSON header of
    ``{name: {dtype, shape, data_offsets}}`` (plus ``__metadata__``), then
    the data, offsets relative to its start. Dtypes BF16, F16, F32, I8 and
    I64; anything else raises."""
    path = Path(path)
    with path.open("rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
        data = bytearray(path.stat().st_size - 8 - n)
        f.readinto(data)
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _SAFETENSORS_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}, "
                             f"not one of {sorted(_SAFETENSORS_DTYPES)}")
        lo, hi = info["data_offsets"]
        shape = info["shape"]
        if hi == lo:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        out[name] = torch.frombuffer(data, dtype=dtype, count=(hi - lo) // dtype.itemsize,
                                     offset=lo).reshape(shape)
    return out


def _load_safetensors(path: Path) -> Dict[str, np.ndarray]:
    return {k: v.float().numpy() if v.dtype == torch.bfloat16 else v.numpy()
            for k, v in read_safetensors(path).items()}


def _load_torch(path: Path) -> Dict[str, np.ndarray]:
    sd = torch.load(str(path), map_location="cpu", weights_only=True)
    for wrapper in ("state_dict", "model", "model_state", "model_state_dict"):
        if isinstance(sd, dict) and wrapper in sd and isinstance(sd[wrapper], dict):
            sd = sd[wrapper]
            break
    return {k: (v.float() if v.dtype == torch.bfloat16 else v).numpy()
            for k, v in sd.items() if isinstance(v, torch.Tensor)}


# ---------------------------------------------------------------------------
# Checkpoint bring-up CLI
# ---------------------------------------------------------------------------

def bringup_qwen3_vl(model_path, max_new_tokens: int = 32, tokenizer=None,
                     image_size: int = 128, device: str = "cuda",
                     cache_params: bool = True) -> Dict:
    """Prove a Qwen3-VL HF checkpoint end to end on this stack: load the
    (sharded) safetensors and convert -> one encoder-tap forward and a
    text embedding -> a short greedy generation, checking finiteness, then
    a tokenizer round trip. Returns a summary dict (also printed by the
    CLI), with the keys of ``emr2a_tpu/models/convert.py:bringup_qwen3_vl``.

    ``tokenizer`` may be injected (the card's machine has no
    ``transformers``); only the checkpoint's own tokenizer must pass the
    round trip. ``cache_params`` (the CLI's ``--no-cache`` turns it off)
    loads through the converted-params cache beside the checkpoint
    (``models/checkpoint.load_or_convert``), so ``load_convert_s`` of a
    second run is the cache's read.
    """
    import time

    from emr2a_tpu_torch.encoders.qwen3_vl_encoder import Qwen3VLEncoder
    from emr2a_tpu_torch.judge.qwen_backend import QwenVLBackend

    t0 = time.time()
    backend = QwenVLBackend(str(model_path), device=device, tokenizer=tokenizer,
                            cache_params=cache_params)
    summary: Dict = {"model_path": str(model_path),
                     "load_convert_s": round(time.time() - t0, 1)}

    # encoder taps (hook semantics) on a synthetic CT-like slice
    rng = np.random.RandomState(0)
    img = (rng.rand(image_size, image_size, 3) * 255).astype(np.uint8)
    enc = Qwen3VLEncoder(model=backend.model, tokenizer=backend.tokenizer,
                         image_processor=backend.image_processor)
    t0 = time.time()
    emb = enc.encode_batch_images([img])[0]
    if emb is None or not np.isfinite(emb).all():
        raise AssertionError("vision tap embedding is missing/non-finite")
    summary["image_tap_dim"] = int(emb.shape[0])
    summary["image_tap_s"] = round(time.time() - t0, 1)

    t0 = time.time()
    txt_emb = enc.encode_batch_texts(["性别: 男; 年龄: 63; 发热: 有"])[0]
    if txt_emb is None or not np.isfinite(txt_emb).all():
        raise AssertionError("text embedding is missing/non-finite")
    summary["text_dim"] = int(txt_emb.shape[0])
    summary["text_s"] = round(time.time() - t0, 1)

    t0 = time.time()
    out = backend.generate([img], "Describe this CT slice briefly.",
                           max_new_tokens=max_new_tokens, temperature=0.0)
    summary["generate_s"] = round(time.time() - t0, 1)
    summary["generated"] = out[:200]
    if not isinstance(out, str):
        raise AssertionError("generation did not return text")

    # tokenizer round trip: decode(encode(text)) must contain the text
    # (strict: a tokenizer with the wrong vocabulary decodes something);
    # an injected tokenizer gets the honest answer in the summary
    probe = "CT slice audit."
    ids = backend.tokenizer(probe, add_special_tokens=False)["input_ids"]
    rt = backend.tokenizer.decode(ids, skip_special_tokens=True)
    summary["tokenizer_roundtrip_ok"] = bool(probe.strip() in rt)
    if tokenizer is None and not summary["tokenizer_roundtrip_ok"]:
        raise AssertionError(f"tokenizer round-trip failed: {rt!r}")
    return summary


def _main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description="Checkpoint conversion bring-up checks")
    ap.add_argument("--qwen3-vl", dest="qwen3_vl", default=None,
                    help="HF Qwen3-VL checkpoint dir: convert + tap "
                         "forward + short greedy generation")
    ap.add_argument("--max-new-tokens", type=int, default=32)
    ap.add_argument("--image-size", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--no-cache", action="store_true",
                    help="skip the converted-params cache beside the checkpoint")
    args = ap.parse_args(argv)
    if not args.qwen3_vl:
        ap.error("nothing to do: pass --qwen3-vl <dir>")
    summary = bringup_qwen3_vl(args.qwen3_vl, max_new_tokens=args.max_new_tokens,
                               image_size=args.image_size, device=args.device,
                               cache_params=not args.no_cache)
    print(json.dumps(summary, ensure_ascii=False))


if __name__ == "__main__":
    _main()
