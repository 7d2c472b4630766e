"""Plain reference of Kimi-VL-A3B (moonshotai/Kimi-VL-A3B-Instruct's
published architecture: its ``config.json`` and modeling code) in float32
with TF32 off. It imports nothing of the program and nothing of JAX, and
takes only seeded weights (in the program's names, kernels (in, out)),
images and token ids.

- Image processing: pixels / 255, mean and std 0.5, patches of (3, 14,
  14) in row-major grid order (the sides must be multiples of 28: no
  resize).
- MoonViT: the patch embedding, the learned 64 x 64 position table
  bicubically interpolated to the grid (``align_corners=False``), the 2D
  rotary as complex numbers on adjacent pairs (pair 2k: the column's
  angle, pair 2k + 1: the row's, frequency 10000^(-4k/72)), pre-LN blocks
  (eps 1e-5, attention within the image, GELU-tanh MLP), a final
  LayerNorm, then each 2 x 2 block gathered (rows of blocks, a block's
  tokens row-major) and projected: LayerNorm per token, 4,608 -> 4,608,
  exact GELU, 4,608 -> 2,048.
- Decoder: the image placeholders replaced by the projector's output,
  positions 0, 1, 2, ...; RMSNorm (eps 1e-5); MLA un-absorbed (q split
  into nope and rope parts, c_kv normalised (eps 1e-6) and expanded to
  k_nope and v per head, the rotary as DeepSeek writes it: the 64 dims
  de-interleaved, then ``rotate_half``, theta 800,000), causal attention
  at 192^-0.5; layer 0 a dense SwiGLU; the other layers sigmoid routing
  in f32 (top 6 of scores + bias, the chosen scores normalised and times
  the routing scale), each token's output the weighted sum of its chosen
  experts' SwiGLUs (computed expert by expert over the tokens that chose
  it) plus the shared SwiGLU; the final norm and the untied lm_head.

``full_logits`` gives every position's logits of whole sequences;
``teacher_forced_logits`` those that predict each served token. Both run
layer by layer over all the sequences, casting each layer's weights to
float32 once (the weights are held as drawn, e.g. bf16), so that the
whole configuration fits on one card.
"""

from __future__ import annotations

import contextlib
import math
from typing import List

import numpy as np
import torch
import torch.nn.functional as F

KV_NORM_EPS = 1e-6


@contextlib.contextmanager
def exact_f32():
    """float32 products without TF32 for the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def layer_norm(x, w, b, eps):
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * w + b


def rms_norm(x, w, eps):
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * w


def gelu_tanh(x):
    return 0.5 * x * (1 + torch.tanh(math.sqrt(2 / math.pi) * (x + 0.044715 * x ** 3)))


def gelu_erf(x):
    return 0.5 * x * (1 + torch.erf(x / math.sqrt(2)))


def attention(q, k, v, causal: bool = False):
    """q, k (S, H, Dk), v (S, H, Dv) -> (S, H, Dv); softmax of q.k /
    sqrt(Dk)."""
    logits = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(q.shape[-1])
    if causal:
        S = q.shape[0]
        mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~mask, float("-inf"))
    return torch.einsum("hqk,khd->qhd", torch.softmax(logits, dim=-1), v)


def rotate_half(x):
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def weight_plan(cfg: dict) -> list:
    """Parameters in the program's names and (in, out) kernels: kernels,
    embeddings, the position table, biases and the routers' correction
    biases N(0, 0.02); norm scales 1 + N(0, 0.05)."""
    v, t = cfg["vision_config"], cfg
    small, scale = ("normal", 0.02), ("around_one", 0.05)
    D, I = v["hidden_size"], v["intermediate_size"]
    patch = 3 * v["patch_size"] ** 2
    M = D * v["merge_kernel_size"][0] * v["merge_kernel_size"][1]
    plan = [("visual.patch_embed.kernel", (patch, D), small),
            ("visual.patch_embed.bias", (D,), small),
            ("visual.pos_embed", (v["init_pos_emb_height"], v["init_pos_emb_width"], D), small)]
    for i in range(v["num_hidden_layers"]):
        b = f"visual.blocks.{i}."
        plan += [(b + "norm1.weight", (D,), scale), (b + "norm1.bias", (D,), small),
                 (b + "norm2.weight", (D,), scale), (b + "norm2.bias", (D,), small)]
        for name, shape in (("q_proj", (D, D)), ("k_proj", (D, D)), ("v_proj", (D, D)),
                            ("o_proj", (D, D)), ("fc1", (D, I)), ("fc2", (I, D))):
            plan += [(b + f"{name}.kernel", shape, small), (b + f"{name}.bias", (shape[1],), small)]
    plan += [("visual.final_ln.weight", (D,), scale), ("visual.final_ln.bias", (D,), small),
             ("visual.merger.norm.weight", (D,), scale), ("visual.merger.norm.bias", (D,), small),
             ("visual.merger.fc1.kernel", (M, M), small), ("visual.merger.fc1.bias", (M,), small),
             ("visual.merger.fc2.kernel", (M, t["hidden_size"]), small),
             ("visual.merger.fc2.bias", (t["hidden_size"],), small)]
    H, heads = t["hidden_size"], t["num_attention_heads"]
    q_dim = t["qk_nope_head_dim"] + t["qk_rope_head_dim"]
    R, E, Ie = t["kv_lora_rank"], t["n_routed_experts"], t["moe_intermediate_size"]
    plan.append(("language_model.embed_tokens.embedding", (t["vocab_size"], H), small))
    for i in range(t["num_hidden_layers"]):
        b = f"language_model.layers.{i}."
        plan += [(b + "input_ln.weight", (H,), scale), (b + "post_ln.weight", (H,), scale),
                 (b + "attn.q_proj.kernel", (H, heads * q_dim), small),
                 (b + "attn.kv_a_proj.kernel", (H, R + t["qk_rope_head_dim"]), small),
                 (b + "attn.kv_a_ln.weight", (R,), scale),
                 (b + "attn.kv_b_proj.kernel",
                  (R, heads * (t["qk_nope_head_dim"] + t["v_head_dim"])), small),
                 (b + "attn.o_proj.kernel", (heads * t["v_head_dim"], H), small)]
        if i < t["first_k_dense_replace"]:
            F_ = t["intermediate_size"]
            plan += [(b + "mlp.gate_proj.kernel", (H, F_), small),
                     (b + "mlp.up_proj.kernel", (H, F_), small),
                     (b + "mlp.down_proj.kernel", (F_, H), small)]
            continue
        S_ = Ie * t["n_shared_experts"]
        plan += [(b + "moe.router", (H, E), small), (b + "moe.router_bias", (E,), small),
                 (b + "moe.experts_gate_up", (E, H, 2 * Ie), small),
                 (b + "moe.experts_down", (E, Ie, H), small),
                 (b + "moe.shared.gate_proj.kernel", (H, S_), small),
                 (b + "moe.shared.up_proj.kernel", (H, S_), small),
                 (b + "moe.shared.down_proj.kernel", (S_, H), small)]
    plan += [("language_model.final_ln.weight", (H,), scale),
             ("language_model.lm_head.kernel", (H, t["vocab_size"]), small)]
    return plan


# -- MoonViT ----------------------------------------------------------------


def image_patches(image: np.ndarray, cfg: dict):
    """(H, W, 3) uint8 -> ((gh * gw, 3 * p * p) f32 patches, row-major over
    the grid, each (c, y, x); (gh, gw))."""
    v = cfg["vision_config"]
    p, m = v["patch_size"], v["merge_kernel_size"][0]
    H, W, C = image.shape
    if H % (p * m) or W % (p * m):
        raise ValueError(f"the reference takes sides that are multiples of {p * m}")
    x = (image.astype(np.float64) / 255.0 - 0.5) / 0.5
    gh, gw = H // p, W // p
    x = x.transpose(2, 0, 1).reshape(C, gh, p, gw, p).transpose(1, 3, 0, 2, 4)
    return x.reshape(gh * gw, C * p * p).astype(np.float32), (gh, gw)


def vision_rope(gh: int, gw: int, head_dim: int, device) -> torch.Tensor:
    """(gh * gw, head_dim / 2) complex: token (r, c)'s pair 2k turns by
    c * f_k and pair 2k + 1 by r * f_k, f_k = 10000^(-4k / head_dim)."""
    freqs = 1.0 / 10000.0 ** (torch.arange(0, head_dim, 4, device=device)[: head_dim // 4]
                              .float() / head_dim)
    pos = torch.arange(gh * gw, device=device)
    xs, ys = (pos % gw).float(), (pos // gw).float()
    x_cis = torch.polar(torch.ones(gh * gw, len(freqs), device=device), torch.outer(xs, freqs))
    y_cis = torch.polar(torch.ones(gh * gw, len(freqs), device=device), torch.outer(ys, freqs))
    return torch.stack([x_cis, y_cis], dim=-1).reshape(gh * gw, -1)


def rope_complex(x: torch.Tensor, cis: torch.Tensor) -> torch.Tensor:
    """x (S, H, D) real, adjacent pairs as complex numbers, times cis (S, D/2)."""
    xc = torch.view_as_complex(x.float().reshape(*x.shape[:-1], -1, 2).contiguous())
    return torch.view_as_real(xc * cis[:, None, :]).flatten(-2).to(x.dtype)


def vision_tower(w, patches: torch.Tensor, grid, cfg: dict) -> torch.Tensor:
    """One image's patches -> its merged tokens (gh * gw / 4, 2048)."""
    v = cfg["vision_config"]
    D, heads, m = v["hidden_size"], v["num_attention_heads"], v["merge_kernel_size"][0]
    hd = D // heads
    gh, gw = grid
    x = patches @ w("visual.patch_embed.kernel") + w("visual.patch_embed.bias")
    table = w("visual.pos_embed")
    if tuple(table.shape[:2]) != (gh, gw):
        table = F.interpolate(table.permute(2, 0, 1)[None], size=(gh, gw), mode="bicubic",
                              align_corners=False)[0].permute(1, 2, 0)
    x = x + table.reshape(gh * gw, D)
    cis = vision_rope(gh, gw, hd, x.device)
    for i in range(v["num_hidden_layers"]):
        b = f"visual.blocks.{i}."
        h = layer_norm(x, w(b + "norm1.weight"), w(b + "norm1.bias"), 1e-5)
        q, k, val = ((h @ w(b + f"{n}.kernel") + w(b + f"{n}.bias")).reshape(-1, heads, hd)
                     for n in ("q_proj", "k_proj", "v_proj"))
        a = attention(rope_complex(q, cis), rope_complex(k, cis), val).reshape(-1, D)
        x = x + a @ w(b + "o_proj.kernel") + w(b + "o_proj.bias")
        h = layer_norm(x, w(b + "norm2.weight"), w(b + "norm2.bias"), 1e-5)
        x = x + gelu_tanh(h @ w(b + "fc1.kernel") + w(b + "fc1.bias")) @ w(b + "fc2.kernel") \
            + w(b + "fc2.bias")
    x = layer_norm(x, w("visual.final_ln.weight"), w("visual.final_ln.bias"), 1e-5)
    blocks = x.view(gh // m, m, gw // m, m, D).permute(0, 2, 1, 3, 4).reshape(-1, m * m, D)
    h = layer_norm(blocks, w("visual.merger.norm.weight"), w("visual.merger.norm.bias"), 1e-5)
    h = gelu_erf(h.reshape(-1, m * m * D) @ w("visual.merger.fc1.kernel")
                 + w("visual.merger.fc1.bias"))
    return h @ w("visual.merger.fc2.kernel") + w("visual.merger.fc2.bias")


# -- decoder ---------------------------------------------------------------


def mla_rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """DeepSeek-V3's rotary: x (S, H, d) de-interleaved (even dims, then odd
    ones), then ``x cos + rotate_half(x) sin`` with cos / sin of pos x
    theta^(-2i / d) over i < d / 2, repeated for both halves."""
    d = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, device=x.device).float() / d)
    ang = torch.outer(pos.float(), inv)
    emb = torch.cat([ang, ang], dim=-1)[:, None, :]
    x = x.reshape(*x.shape[:-1], d // 2, 2).transpose(-1, -2).reshape(x.shape)
    return (x * emb.cos() + rotate_half(x) * emb.sin()).to(x.dtype)


def swiglu(x, w, b):
    return (F.silu(x @ w(b + "gate_proj.kernel")) * (x @ w(b + "up_proj.kernel"))) \
        @ w(b + "down_proj.kernel")


def experts(x, w, b: str, t: dict, chosen=None, stats=None) -> torch.Tensor:
    """The expert layer over tokens x (S, H). ``chosen`` (S, top_k): the
    program's choices, taken in place of the reference's own top k of
    scores + bias; ``stats`` then gathers how far each choice lies from the
    reference's own: its ``margin`` (by how much the best score + bias left
    out exceeds the least taken, 0 where the choice is the reference's
    own top k), ``swapped`` (choices that differ) and ``decisions``."""
    scores = torch.sigmoid(x @ w(b + "router"))
    biased = scores + w(b + "router_bias").to(scores.dtype)
    own = torch.topk(biased, t["num_experts_per_tok"], dim=-1).indices
    if chosen is None:
        chosen = own
    else:
        chosen = chosen.to(x.device, torch.int64)
        taken = torch.zeros_like(biased, dtype=torch.bool).scatter_(1, chosen, True)
        least = biased.masked_fill(~taken, float("inf")).min(dim=-1).values
        best_left = biased.masked_fill(taken, float("-inf")).max(dim=-1).values
        margin = (best_left - least).clamp(min=0).float()
        stats["margin"] = max(stats.get("margin", 0.0), float(margin.max()))
        differs = (torch.sort(chosen, dim=-1).values != torch.sort(own, dim=-1).values).any(-1)
        stats["swapped"] = stats.get("swapped", 0) + int(differs.sum())
        stats["decisions"] = stats.get("decisions", 0) + len(chosen)
    weights = scores.gather(1, chosen)
    weights = weights / (weights.sum(dim=-1, keepdim=True) + 1e-20) * t["routed_scaling_factor"]
    gate_up, down = w(b + "experts_gate_up"), w(b + "experts_down")
    Ie = t["moe_intermediate_size"]
    out = torch.zeros_like(x)
    for e in range(t["n_routed_experts"]):
        tok, slot = (chosen == e).nonzero(as_tuple=True)
        if not len(tok):
            continue
        gu = x[tok] @ gate_up[e]
        y = (F.silu(gu[:, :Ie]) * gu[:, Ie:]) @ down[e]
        out.index_add_(0, tok, weights[tok, slot][:, None] * y)
    return out + swiglu(x, w, b + "shared.")


def _layer(x, w, b: str, i: int, t: dict, chosen=None, stats=None):
    heads, nope, rope = t["num_attention_heads"], t["qk_nope_head_dim"], t["qk_rope_head_dim"]
    R, eps = t["kv_lora_rank"], t["rms_norm_eps"]
    S = x.shape[0]
    pos = torch.arange(S, device=x.device)
    h = rms_norm(x, w(b + "input_ln.weight"), eps)
    q = (h @ w(b + "attn.q_proj.kernel")).reshape(S, heads, nope + rope)
    ckv = h @ w(b + "attn.kv_a_proj.kernel")
    c = rms_norm(ckv[:, :R], w(b + "attn.kv_a_ln.weight"), KV_NORM_EPS)
    kv = (c @ w(b + "attn.kv_b_proj.kernel")).reshape(S, heads, -1)
    q_pe = mla_rope(q[..., nope:], pos, float(t["rope_theta"]))
    k_pe = mla_rope(ckv[:, None, R:], pos, float(t["rope_theta"])).expand(S, heads, rope)
    a = attention(torch.cat([q[..., :nope], q_pe], dim=-1),
                  torch.cat([kv[..., :nope], k_pe], dim=-1), kv[..., nope:], causal=True)
    x = x + a.reshape(S, -1) @ w(b + "attn.o_proj.kernel")
    h = rms_norm(x, w(b + "post_ln.weight"), eps)
    if i < t["first_k_dense_replace"]:
        return x + swiglu(h, w, b + "mlp.")
    return x + experts(h, w, b + "moe.", t, chosen, stats)


def _hidden(weights: dict, sequences: List[dict], cfg: dict, device, stats=None,
            dtype=torch.float32) -> list:
    """Final-norm hidden states (S, H) of each sequence ({"ids", "images"},
    and optionally "routes": the program's choices, (expert layers, S,
    top_k), which ``experts`` takes, gathering into ``stats``). ``dtype``
    the weights' and activations' (float32; bfloat16 only as a witness of
    what bf16 rounding moves)."""
    t = cfg
    image_token = cfg["image_token_id"]
    f32 = {}

    def w(name):
        if name not in f32:
            f32[name] = weights[name].to(device).to(dtype)
        return f32[name]

    states = []
    for s in sequences:
        ids = torch.tensor(list(s["ids"]), device=device)
        x = w("language_model.embed_tokens.embedding")[ids]
        feats = []
        for img in s["images"]:
            patches, grid = image_patches(np.asarray(img), cfg)
            feats.append(vision_tower(w, torch.from_numpy(patches).to(device, dtype), grid,
                                      cfg))
        if feats:
            x[ids == image_token] = torch.cat(feats)
        states.append(x)
    f32.clear()
    first = t["first_k_dense_replace"]
    for i in range(t["num_hidden_layers"]):
        b = f"language_model.layers.{i}."
        states = [_layer(x, w, b, i, t,
                         s["routes"][i - first] if "routes" in s and i >= first else None,
                         stats)
                  for x, s in zip(states, sequences)]
        f32.clear()
    return [rms_norm(x, w("language_model.final_ln.weight"), t["rms_norm_eps"]) for x in states]


def full_logits(weights: dict, sequences: List[dict], cfg: dict, device) -> list:
    """Every position's (S, vocab) f32 logits of each sequence (dicts of
    ``ids``, with each image's placeholders expanded, and ``images``)."""
    with exact_f32(), torch.no_grad():
        hidden = _hidden(weights, sequences, cfg, device)
        head = weights["language_model.lm_head.kernel"].to(device).float()
        return [h @ head for h in hidden]


def teacher_forced_logits(weights: dict, requests: List[dict], cfg: dict, device,
                          stats=None, dtype=torch.float32) -> list:
    """``requests``: dicts of ``ids`` (the prompt, placeholders expanded),
    ``images`` ((H, W, 3) uint8), ``served`` (the tokens judged) and
    optionally ``routes`` (the program's expert choices over ``ids`` and
    ``served[:-1]``, (expert layers, positions, top_k): see ``experts``;
    ``stats`` gathers how they lie against the reference's scores).
    Returns, per request, the (len(served), vocab) f32 logits that predict
    each served token."""
    seqs = [{"ids": list(r["ids"]) + list(r["served"][:-1]), "images": r["images"],
             **({"routes": r["routes"]} if r.get("routes") is not None else {})}
            for r in requests]
    with exact_f32(), torch.no_grad():
        hidden = _hidden(weights, seqs, cfg, device, stats, dtype)
        head = weights["language_model.lm_head.kernel"].to(device).to(dtype)
        return [(h[len(r["ids"]) - 1:len(r["ids"]) - 1 + len(r["served"])] @ head).float()
                for h, r in zip(hidden, requests)]
