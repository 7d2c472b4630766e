"""The judge's share of the chip's bf16 peak over the traced window: the
model's operations for the requests served there, over 989 TFLOP/s times
the window.

Counted per request (``request_flops``): the vision tower on each image,
the prefill of the prompt's tokens (a wave's shared prefix once a wave,
``prefix_flops``) and one decoder forward per served token after the
first, with causal attention over the positions before it and the lm_head
at each position that yields a token. Per image of F frames of S patches
(N = F S), tower width D, depth L_v, MLP I, merge m, output width O:
2 N (C t p^2) D + L_v (8 N D^2 + 4 F S^2 D + 4 N D I) + (1 + deepstack)
(N / m^2)(2 M^2 + 2 M O) with M = D m^2. Per decoder token at position t:
L (2 (H (q + 2 kv) + q H + 3 H F) + 4 q (t + 1)), q and kv the query and
key-value widths; the lm_head 2 H V.
"""

from benchmark.core.peaks import BF16_FLOPS


def image_flops(cfg: dict, grid) -> float:
    v = cfg["vision"]
    F, h, w = grid
    S, N = h * w, grid[0] * h * w
    D, I, m = v["hidden_size"], v["intermediate_size"], v["spatial_merge_size"]
    patch = v["in_channels"] * v["temporal_patch_size"] * v["patch_size"] ** 2
    M = D * m * m
    mergers = (1 + len(v["deepstack_visual_indexes"])) * (N // (m * m)) * (
        2 * M * M + 2 * M * v["out_hidden_size"])
    return 2 * N * patch * D + v["depth"] * (8 * N * D * D + 4 * F * S * S * D + 4 * N * D * I) \
        + mergers


def _token_flops(cfg: dict, first: int, last: int) -> float:
    """Decoder operations (without the lm_head) for positions first..last-1."""
    t = cfg["text"]
    H, F = t["hidden_size"], t["intermediate_size"]
    q, kv = t["num_attention_heads"] * t["head_dim"], t["num_key_value_heads"] * t["head_dim"]
    n = last - first
    linear = 2 * (H * (q + 2 * kv) + q * H + 3 * H * F)
    keys = (last * (last + 1) - first * (first + 1)) // 2          # sum of (pos + 1)
    return t["num_hidden_layers"] * (n * linear + 4 * q * keys)


def request_flops(cfg: dict, req: dict, shared: int) -> float:
    t = cfg["text"]
    head = 2 * t["hidden_size"] * t["vocab_size"]
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
