"""The image tower's share of the chip's bf16 peak over the traced
window: the tower's operations for the slices embedded there, over 989
TFLOP/s times the window.

Operations per slice of a ViT at image size s, patch p, width d, depth L,
MLP width m, projection P, with N = (s / p)^2 patches and S = N + 1
tokens: 2 N (3 p^2) d for the patch embedding, L (8 S d^2 + 4 S^2 d +
4 S d m) for the blocks, 2 d P for the head: 35.1 GFLOP for ViT-B/16 at
224.
"""

from benchmark.core.peaks import BF16_FLOPS


def flops_per_slice(cfg: dict) -> float:
    s, p, d = cfg["image_size"], cfg["patch_size"], cfg["hidden_size"]
    L, m, P = cfg["num_hidden_layers"], cfg["intermediate_size"], cfg["projection_dim"]
    N = (s // p) ** 2
    S = N + 1
    return 2 * N * 3 * p * p * d + L * (8 * S * d * d + 4 * S * S * d + 4 * S * d * m) + 2 * d * P


def read(run):
    if run.device is None or not run.traced or run.device.window_s <= 0:
        return None
    slices = sum(r["items"] - r["failed"] for r in run.traced)
    return 100.0 * slices * flops_per_slice(run.config) / (BF16_FLOPS * run.device.window_s)
