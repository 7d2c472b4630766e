"""Plain reference of Qwen3-VL (Qwen/Qwen3-VL-8B-Instruct's published
architecture, its ``config.json`` widths) in float32 with TF32 off. It
imports nothing of the program and takes only the benchmark's seeded
weights, images and the served tokens it judges.

- Image processing: Qwen's patch layout: pixels / 255, the CLIP mean and
  std, the frame repeated to the temporal patch, patches of (C, t, p, p)
  in 2 x 2 merge-block order (the cells' 512 x 512 slices need no
  resize: 512 is a multiple of patch x merge = 32).
- Vision tower: patch embedding, the learned 48 x 48 position table
  bilinearly interpolated to the grid, 2D rotary (rows, then columns) on
  each head, pre-LN blocks (attention within each image, GELU-tanh MLP),
  deepstack mergers after the blocks ``deepstack_visual_indexes`` (LN over
  the merged 2 x 2 tokens) and the final merger (LN per token), exact GELU.
- Decoder: token embeddings with the image tokens replaced by the tower's
  output, interleaved M-RoPE (t / h / w frequencies, sections 24 / 20 /
  20), RMSNorm, GQA with QK-norm, causal attention, SwiGLU, the deepstack
  features added at the image positions after the first layers, the final
  norm and the untied lm_head.

``teacher_forced_logits`` runs whole prompts with their served tokens,
layer by layer over every request, so that each layer's weights are cast
to float32 once.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from benchmark.reference.common import (
    attention,
    exact_f32,
    gelu_erf,
    gelu_tanh,
    layer_norm,
    rms_norm,
    rotate_half,
)


def weight_plan(cfg: dict) -> list:
    """Parameters in the program's names and (in, out) kernels: kernels,
    embeddings, the position table and biases N(0, 0.02); norm scales
    1 + N(0, 0.05)."""
    v, t = cfg["vision"], cfg["text"]
    small, scale = ("normal", 0.02), ("around_one", 0.05)
    D, I = v["hidden_size"], v["intermediate_size"]
    patch = v["in_channels"] * v["temporal_patch_size"] * v["patch_size"] ** 2
    M = D * v["spatial_merge_size"] ** 2
    out = v["out_hidden_size"]
    plan = [("visual.pos_embed", (v["num_position_embeddings"], D), small),
            ("visual.patch_embed.kernel", (patch, D), small),
            ("visual.patch_embed.bias", (D,), small)]
    for i in range(v["depth"]):
        b = f"visual.blocks.{i}."
        plan += [(b + "norm1.weight", (D,), scale), (b + "norm1.bias", (D,), small),
                 (b + "norm2.weight", (D,), scale), (b + "norm2.bias", (D,), small)]
        for name, shape in (("q_proj", (D, D)), ("k_proj", (D, D)), ("v_proj", (D, D)),
                            ("o_proj", (D, D)), ("fc1", (D, I)), ("fc2", (I, D))):
            plan += [(b + f"{name}.kernel", shape, small), (b + f"{name}.bias", (shape[1],), small)]
    mergers = [f"visual.deepstack_mergers.{j}." for j in range(len(v["deepstack_visual_indexes"]))]
    for b in mergers + ["visual.merger."]:
        n = M if "deepstack" in b else D
        plan += [(b + "norm.weight", (n,), scale), (b + "norm.bias", (n,), small),
                 (b + "fc1.kernel", (M, M), small), (b + "fc1.bias", (M,), small),
                 (b + "fc2.kernel", (M, out), small), (b + "fc2.bias", (out,), small)]
    H, hd = t["hidden_size"], t["head_dim"]
    nq, nkv, F = t["num_attention_heads"] * hd, t["num_key_value_heads"] * hd, t["intermediate_size"]
    plan.append(("language_model.embed_tokens.embedding", (t["vocab_size"], H), small))
    for i in range(t["num_hidden_layers"]):
        b = f"language_model.layers.{i}."
        plan += [(b + "q_norm_scale", (hd,), scale), (b + "k_norm_scale", (hd,), scale),
                 (b + "input_ln.weight", (H,), scale), (b + "post_ln.weight", (H,), scale)]
        for name, shape in (("q_proj", (H, nq)), ("k_proj", (H, nkv)), ("v_proj", (H, nkv)),
                            ("o_proj", (nq, H)), ("gate_proj", (H, F)), ("up_proj", (H, F)),
                            ("down_proj", (F, H))):
            plan.append((b + f"{name}.kernel", shape, small))
    plan += [("language_model.final_ln.weight", (H,), scale),
             ("language_model.lm_head.kernel", (H, t["vocab_size"]), small)]
    return plan


# -- images ----------------------------------------------------------------


def image_patches(image: np.ndarray, cfg: dict):
    """(H, W, 3) uint8 -> ((gh * gw, C * t * p * p) f32 patches, (1, gh, gw))."""
    v = cfg["vision"]
    p, m, tp = v["patch_size"], v["spatial_merge_size"], v["temporal_patch_size"]
    H, W, C = image.shape
    if H % (p * m) or W % (p * m):
        raise ValueError(f"the reference takes sides that are multiples of {p * m}")
    x = (image.astype(np.float64) * (1 / 255)).astype(np.float32)
    x = (x - np.asarray(cfg["image_mean"], np.float32)) / np.asarray(cfg["image_std"], np.float32)
    frames = np.repeat(x.transpose(2, 0, 1)[None], tp, axis=0)
    gh, gw = H // p, W // p
    x = frames.reshape(1, tp, C, gh // m, m, p, gw // m, m, p).transpose(0, 3, 6, 4, 7, 2, 1, 5, 8)
    return x.reshape(gh * gw, C * tp * p * p), (1, gh, gw)


def _merge_order(h: int, w: int, m: int) -> np.ndarray:
    """Row-major grid index of each token in 2 x 2 merge-block order."""
    r = (np.arange(h // m)[:, None, None, None] * m + np.arange(m)[None, None, :, None])
    c = (np.arange(w // m)[None, :, None, None] * m + np.arange(m)[None, None, None, :])
    r, c = np.broadcast_to(r, (h // m, w // m, m, m)), np.broadcast_to(c, (h // m, w // m, m, m))
    return (r * w + c).reshape(-1), r.reshape(-1), c.reshape(-1)


def vision_tower(w: dict, patches: torch.Tensor, grid, cfg: dict):
    """One image's patches -> (merged tokens (n / 4, out), [deepstack features])."""
    v = cfg["vision"]
    D, heads, m = v["hidden_size"], v["num_heads"], v["spatial_merge_size"]
    hd = D // heads
    _, gh, gw = grid
    dev = patches.device
    x = patches @ w["visual.patch_embed.kernel"] + w["visual.patch_embed.bias"]
    side = int(round(v["num_position_embeddings"] ** 0.5))
    table = w["visual.pos_embed"].reshape(side, side, D)
    hi = torch.linspace(0, side - 1, gh, dtype=torch.float64, device=dev)
    wi = torch.linspace(0, side - 1, gw, dtype=torch.float64, device=dev)
    h0, w0 = hi.floor().long(), wi.floor().long()
    h1, w1 = (h0 + 1).clamp(max=side - 1), (w0 + 1).clamp(max=side - 1)
    dh, dw = (hi - h0).float()[:, None, None], (wi - w0).float()[None, :, None]
    pos = ((1 - dh) * (1 - dw) * table[h0][:, w0] + (1 - dh) * dw * table[h0][:, w1]
           + dh * (1 - dw) * table[h1][:, w0] + dh * dw * table[h1][:, w1]).reshape(gh * gw, D)
    order, rows, cols = _merge_order(gh, gw, m)
    x = x + pos[torch.from_numpy(order).to(dev)]
    inv = 1.0 / 10000.0 ** (torch.arange(0, hd // 2, 2, dtype=torch.float32, device=dev) / (hd // 2))
    freqs = torch.cat([torch.from_numpy(rows).to(dev).float()[:, None] * inv,
                       torch.from_numpy(cols).to(dev).float()[:, None] * inv], dim=-1)
    emb = torch.cat([freqs, freqs], dim=-1)[:, None, :]
    cos, sin = emb.cos(), emb.sin()
    deep = []
    for i in range(v["depth"]):
        b = f"visual.blocks.{i}."
        h = layer_norm(x, w[b + "norm1.weight"], w[b + "norm1.bias"], 1e-6)
        q, k, val = ((h @ w[b + f"{n}.kernel"] + w[b + f"{n}.bias"]).reshape(-1, heads, hd)
                     for n in ("q_proj", "k_proj", "v_proj"))
        q, k = q * cos + rotate_half(q) * sin, k * cos + rotate_half(k) * sin
        a = attention(q, k, val).reshape(-1, D)
        x = x + a @ w[b + "o_proj.kernel"] + w[b + "o_proj.bias"]
        h = layer_norm(x, w[b + "norm2.weight"], w[b + "norm2.bias"], 1e-6)
        x = x + gelu_tanh(h @ w[b + "fc1.kernel"] + w[b + "fc1.bias"]) @ w[b + "fc2.kernel"] \
            + w[b + "fc2.bias"]
        if i in v["deepstack_visual_indexes"]:
            j = v["deepstack_visual_indexes"].index(i)
            deep.append(_merger(w, f"visual.deepstack_mergers.{j}.", x, m, True))
    return _merger(w, "visual.merger.", x, m, False), deep


def _merger(w, b, x, m, postshuffle):
    merged = x.shape[-1] * m * m
    if postshuffle:
        h = layer_norm(x.reshape(-1, merged), w[b + "norm.weight"], w[b + "norm.bias"], 1e-6)
    else:
        h = layer_norm(x, w[b + "norm.weight"], w[b + "norm.bias"], 1e-6).reshape(-1, merged)
    h = gelu_erf(h @ w[b + "fc1.kernel"] + w[b + "fc1.bias"])
    return h @ w[b + "fc2.kernel"] + w[b + "fc2.bias"]


# -- decoder ---------------------------------------------------------------


def mrope_positions(ids: Sequence[int], grids, image_token: int, m: int) -> np.ndarray:
    """(3, S) t / h / w positions: text advances all three together; an
    image's tokens take its (t, row, column) on the merged grid, offset by
    the text before it; text after it resumes past the image's largest."""
    ids = np.asarray(ids)
    pos = np.zeros((3, len(ids)), np.int64)
    nxt, i, img = 0, 0, 0
    while i < len(ids):
        if ids[i] != image_token:
            pos[:, i] = nxt
            nxt += 1
            i += 1
            continue
        t, h, w_ = grids[img]
        img += 1
        gh, gw = h // m, w_ // m
        n = t * gh * gw
        tt, hh, ww = np.meshgrid(np.arange(t), np.arange(gh), np.arange(gw), indexing="ij")
        pos[:, i:i + n] = np.stack([tt.reshape(-1), hh.reshape(-1), ww.reshape(-1)]) + nxt
        nxt = int(pos[:, i:i + n].max()) + 1
        i += n
    return pos


def mrope_cos_sin(pos: torch.Tensor, cfg: dict):
    t = cfg["text"]
    hd = t["head_dim"]
    inv = 1.0 / float(t["rope_theta"]) ** (
        torch.arange(0, hd, 2, dtype=torch.float32, device=pos.device) / hd)
    freqs = pos.float()[:, :, None] * inv                   # (3, S, hd / 2)
    idx = torch.arange(hd // 2, device=pos.device)
    f = freqs[0].clone()
    for axis in (1, 2):
        sel = (idx % 3 == axis) & (idx < 3 * t["mrope_section"][axis])
        f[:, sel] = freqs[axis][:, sel]
    emb = torch.cat([f, f], dim=-1)[:, None, :]
    return emb.cos(), emb.sin()


def teacher_forced_logits(weights: dict, requests: List[dict], cfg: dict, device) -> list:
    """``requests``: dicts of ``ids`` (the prompt with each image's tokens
    expanded), ``images`` ((H, W, 3) uint8) and ``served`` (the tokens
    judged). Returns, per request, the (len(served), vocab) f32 logits that
    predict each served token."""
    v, t = cfg["vision"], cfg["text"]
    m, image_token = v["spatial_merge_size"], cfg["image_token_id"]
    heads, kv, hd = t["num_attention_heads"], t["num_key_value_heads"], t["head_dim"]
    eps = t["rms_norm_eps"]
    f32 = {}

    def W(name):
        if name not in f32:
            f32[name] = weights[name].to(device).float()
        return f32[name]

    with exact_f32(), torch.no_grad():
        vis_keys = [k for k in weights if k.startswith("visual.")]
        vw = {k: W(k) for k in vis_keys}
        states = []
        for r in requests:
            seq = list(r["ids"]) + list(r["served"][:-1])
            ids = torch.tensor(seq, device=device)
            x = W("language_model.embed_tokens.embedding")[ids]
            grids, feats, deeps = [], [], []
            for img in r["images"]:
                patches, grid = image_patches(np.asarray(img), cfg)
                f, d = vision_tower(vw, torch.from_numpy(patches).to(device), grid, cfg)
                grids.append(grid)
                feats.append(f)
                deeps.append(d)
            mask = ids == image_token
            x[mask] = torch.cat(feats)
            deep = [torch.cat([d[j] for d in deeps]) for j in range(len(v["deepstack_visual_indexes"]))]
            pos = torch.from_numpy(mrope_positions(seq, grids, image_token, m)).to(device)
            cos, sin = mrope_cos_sin(pos, cfg)
            states.append({"x": x, "mask": mask, "deep": deep, "cos": cos, "sin": sin,
                           "P": len(r["ids"]), "n": len(r["served"])})
        for k in vis_keys:
            f32.pop(k)
        del vw
        f32.pop("language_model.embed_tokens.embedding")
        for i in range(t["num_hidden_layers"]):
            b = f"language_model.layers.{i}."
            names = [k for k in weights if k.startswith(b)]
            for s in states:
                x = s["x"]
                h = rms_norm(x, W(b + "input_ln.weight"), eps)
                q = (h @ W(b + "q_proj.kernel")).reshape(-1, heads, hd)
                k = (h @ W(b + "k_proj.kernel")).reshape(-1, kv, hd)
                val = (h @ W(b + "v_proj.kernel")).reshape(-1, kv, hd)
                q, k = rms_norm(q, W(b + "q_norm_scale"), eps), rms_norm(k, W(b + "k_norm_scale"), eps)
                q = q * s["cos"] + rotate_half(q) * s["sin"]
                k = k * s["cos"] + rotate_half(k) * s["sin"]
                rep = heads // kv
                a = attention(q, k.repeat_interleave(rep, dim=1), val.repeat_interleave(rep, dim=1),
                              causal=True).reshape(-1, heads * hd)
                x = x + a @ W(b + "o_proj.kernel")
                h = rms_norm(x, W(b + "post_ln.weight"), eps)
                gate, up = h @ W(b + "gate_proj.kernel"), h @ W(b + "up_proj.kernel")
                x = x + (torch.nn.functional.silu(gate) * up) @ W(b + "down_proj.kernel")
                if i < len(s["deep"]):
                    x[s["mask"]] = x[s["mask"]] + s["deep"][i]
                s["x"] = x
            for k in names:
                f32.pop(k, None)
        out = []
        for s in states:
            h = rms_norm(s["x"][s["P"] - 1:s["P"] - 1 + s["n"]], W("language_model.final_ln.weight"),
                         eps)
            out.append(h @ W("language_model.lm_head.kernel"))
    return out
