"""Kimi-VL's share of the chip's bf16 peak over the traced window: the
model's operations for the requests served there, in the published form,
over 989 TFLOP/s times the window.

Counted per request (``request_flops``): MoonViT on each image, the prefill
of the prompt's tokens (a wave's shared prefix once a wave,
``prefix_flops``) and one decoder forward per served token after the
first, with causal attention over the positions before it and the lm_head
at each position that yields a token. Per image of N = h w patches, tower
width D, depth L_v, MLP I, merged width M = 4 D, output width O:
2 N (3 p^2) D + L_v (8 N D^2 + 4 N^2 D + 4 N D I) + (N / 4)(2 M^2 + 2 M O).
Per decoder token at position t, MLA un-absorbed (heads h, q width 192 =
nope + rope, latent 512 + 64, k_nope and v 128 each): 2 H (h 192) + 2 H
576 + 2 512 (h 256) + 2 (h 128) H, attention 2 h (t + 1) (192 + 128); the
FFN: layer 0 dense, 6 H F_d; the expert layers the router 2 H E, the top k
experts 6 k H F_e and the shared ones 6 H (s F_e). The lm_head 2 H V.
"""

from benchmark.core.peaks import BF16_FLOPS


def image_flops(cfg: dict, grid) -> float:
    v = cfg["vision_config"]
    _, h, w = grid
    N = h * w
    D, I, m = v["hidden_size"], v["intermediate_size"], v["merge_kernel_size"][0]
    M = D * m * m
    merger = (N // (m * m)) * (2 * M * M + 2 * M * cfg["hidden_size"])
    return 2 * N * 3 * v["patch_size"] ** 2 * D + v["num_hidden_layers"] * (
        8 * N * D * D + 4 * N * N * D + 4 * N * D * I) + merger


def _layer_linear(cfg: dict, layer: int) -> float:
    """A decoder layer's operations per token outside attention's scores."""
    H, h = cfg["hidden_size"], cfg["num_attention_heads"]
    qd = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    R = cfg["kv_lora_rank"]
    mla = 2 * H * h * qd + 2 * H * (R + cfg["qk_rope_head_dim"]) \
        + 2 * R * h * (cfg["qk_nope_head_dim"] + cfg["v_head_dim"]) + 2 * h * cfg["v_head_dim"] * H
    if layer < cfg["first_k_dense_replace"]:
        return mla + 6 * H * cfg["intermediate_size"]
    Fe = cfg["moe_intermediate_size"]
    return mla + 2 * H * cfg["n_routed_experts"] + 6 * cfg["num_experts_per_tok"] * H * Fe \
        + 6 * H * cfg["n_shared_experts"] * Fe


def _token_flops(cfg: dict, first: int, last: int) -> float:
    """Decoder operations (without the lm_head) for positions first..last-1."""
    n = last - first
    h = cfg["num_attention_heads"]
    qd = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    keys = (last * (last + 1) - first * (first + 1)) // 2          # sum of (pos + 1)
    linear = sum(_layer_linear(cfg, i) for i in range(cfg["num_hidden_layers"]))
    return n * linear + cfg["num_hidden_layers"] * 2 * h * (qd + cfg["v_head_dim"]) * keys


def request_flops(cfg: dict, req: dict, shared: int) -> float:
    head = 2 * cfg["hidden_size"] * cfg["vocab_size"]
    P, n = req["prompt_len"], len(req["served"])
    out = sum(image_flops(cfg, g) for g in req["grids"])
    out += _token_flops(cfg, shared, P) + head
    out += _token_flops(cfg, P, P + max(n - 1, 0)) + max(n - 1, 0) * head
    return out


def prefix_flops(cfg: dict, shared: int) -> float:
    return _token_flops(cfg, 0, shared)


def read(run):
    if run.device is None or not run.traced or run.device.window_s <= 0:
        return None
    total = 0.0
    for rec in run.traced:
        shared = rec["shared_prefix"]
        total += prefix_flops(run.config, shared)
        total += sum(request_flops(run.config, r, shared) for r in rec["requests"])
    return 100.0 * total / (BF16_FLOPS * run.device.window_s)
