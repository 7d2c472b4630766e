"""Plain reference of BioMedCLIP's image tower and case retrieval
(microsoft/BiomedCLIP-PubMedBERT_256-vit_base_patch16_224: timm ViT-B/16
at 224, token (cls) pooling, a bias-free projection to 512, L2
normalisation), in float32 with TF32 off, and the database's top-k in
float64. It imports nothing of the program.

The MLP's GELU is timm's, the exact erf form; the program's fused LN+MLP
block computes the tanh approximation, a departure that the comparison
covers.

Weights follow ``weight_plan`` (the program's parameter names, kernels
(in, out)): kernels N(0, 1/fan_in), the class token, the position table
and every bias N(0, 0.02), LayerNorm scales 1 + N(0, 0.05).
"""

from __future__ import annotations

import torch

from benchmark.reference.common import exact_f32, gelu_erf, layer_norm


def weight_plan(cfg: dict) -> list:
    d, m, p = cfg["hidden_size"], cfg["intermediate_size"], cfg["patch_size"]
    seq = (cfg["image_size"] // p) ** 2 + 1
    small, scale = ("normal", 0.02), ("around_one", 0.05)
    plan = [("trunk.cls_token", (1, 1, d), small), ("trunk.pos_embed", (1, seq, d), small),
            ("trunk.patch_embed.kernel", (p * p * 3, d), ("normal", (p * p * 3) ** -0.5)),
            ("trunk.patch_embed.bias", (d,), small)]
    for i in range(cfg["num_hidden_layers"]):
        b = f"trunk.blocks.{i}."
        plan += [(b + "ln1.weight", (d,), scale), (b + "ln1.bias", (d,), small)]
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            plan += [(b + f"attn.{name}.kernel", (d, d), ("normal", d ** -0.5)),
                     (b + f"attn.{name}.bias", (d,), small)]
        plan += [(b + "ln2.weight", (d,), scale), (b + "ln2.bias", (d,), small),
                 (b + "mlp.fc1.kernel", (d, m), ("normal", d ** -0.5)),
                 (b + "mlp.fc1.bias", (m,), small),
                 (b + "mlp.fc2.kernel", (m, d), ("normal", m ** -0.5)),
                 (b + "mlp.fc2.bias", (d,), small)]
    plan += [("trunk.final_ln.weight", (d,), scale), ("trunk.final_ln.bias", (d,), small),
             ("head_proj.kernel", (d, cfg["projection_dim"]), ("normal", d ** -0.5))]
    return plan


def preprocess(images_u8: torch.Tensor, cfg: dict) -> torch.Tensor:
    """(B, H, W, 3) uint8 at the tower's size -> f32 pixels: / 255, then the
    OpenAI CLIP mean and std (the resize and centre crop are the identity
    at 224 x 224, the size the cells feed)."""
    size = cfg["image_size"]
    if tuple(images_u8.shape[1:3]) != (size, size):
        raise ValueError(f"the reference takes {size} x {size} images")
    mean = torch.tensor(cfg["image_mean"], dtype=torch.float32, device=images_u8.device)
    std = torch.tensor(cfg["image_std"], dtype=torch.float32, device=images_u8.device)
    return (images_u8.float() / 255.0 - mean) / std


def image_embeddings(w: dict, images_u8: torch.Tensor, cfg: dict) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> (B, projection_dim) L2-normalised f32."""
    w = {k: v.float() for k, v in w.items()}
    d, heads, p, eps = cfg["hidden_size"], cfg["num_attention_heads"], cfg["patch_size"], \
        cfg["layer_norm_eps"]
    with exact_f32():
        x = preprocess(images_u8, cfg)
        B, H, W, C = x.shape
        x = x.reshape(B, H // p, p, W // p, p, C).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(B, (H // p) * (W // p), p * p * C)
        x = x @ w["trunk.patch_embed.kernel"] + w["trunk.patch_embed.bias"]
        x = torch.cat([w["trunk.cls_token"].expand(B, 1, d), x], dim=1) + w["trunk.pos_embed"]
        S = x.shape[1]
        for i in range(cfg["num_hidden_layers"]):
            b = f"trunk.blocks.{i}."
            h = layer_norm(x, w[b + "ln1.weight"], w[b + "ln1.bias"], eps)
            q, k, v = (h @ w[b + f"attn.{n}.kernel"] + w[b + f"attn.{n}.bias"]
                       for n in ("q_proj", "k_proj", "v_proj"))
            q, k, v = (t.reshape(B, S, heads, d // heads) for t in (q, k, v))
            logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * (d // heads) ** -0.5
            a = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, -1), v).reshape(B, S, d)
            x = x + a @ w[b + "attn.out_proj.kernel"] + w[b + "attn.out_proj.bias"]
            h = layer_norm(x, w[b + "ln2.weight"], w[b + "ln2.bias"], eps)
            h = gelu_erf(h @ w[b + "mlp.fc1.kernel"] + w[b + "mlp.fc1.bias"])
            x = x + h @ w[b + "mlp.fc2.kernel"] + w[b + "mlp.fc2.bias"]
        pooled = layer_norm(x[:, 0], w["trunk.final_ln.weight"], w["trunk.final_ln.bias"], eps)
        emb = pooled @ w["head_proj.kernel"]
    return emb / emb.norm(dim=-1, keepdim=True)


def top_k(queries: torch.Tensor, rows: torch.Tensor, k: int):
    """Exact top-k of each query's cosine against the database rows (both
    normalised here), in float64, scanned in blocks: (scores, indices)
    descending, ties to the lower index."""
    q = queries.double()
    q = q / q.norm(dim=-1, keepdim=True)
    best_s, best_i = None, None
    for lo in range(0, rows.shape[0], 1 << 18):
        r = rows[lo:lo + (1 << 18)].double()
        s = q @ (r / r.norm(dim=-1, keepdim=True)).T
        s, i = torch.topk(s, min(k, s.shape[1]), dim=1)
        i = i + lo
        if best_s is not None:
            s, i = torch.cat([best_s, s], 1), torch.cat([best_i, i], 1)
            order = torch.argsort(-s, dim=1, stable=True)[:, :k]
            s, i = s.gather(1, order), i.gather(1, order)
        best_s, best_i = s, i
    return best_s, best_i


def scores_of(queries: torch.Tensor, rows: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """float64 cosine of each query against the rows it names."""
    q = queries.double()
    q = q / q.norm(dim=-1, keepdim=True)
    r = rows[indices.flatten()].double().reshape(*indices.shape, -1)
    r = r / r.norm(dim=-1, keepdim=True)
    return torch.einsum("qd,qkd->qk", q, r)
