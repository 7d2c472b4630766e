"""Activation-aware weight-scale folding (AWQ) for int4 serving.

Port of ``emr2a_tpu/models/awq.py`` with its names and its recipe. RTN int4
loses most where the input channels are loud; scaling those channels'
weight rows up (and the activations down by the same factor, folded into
the op before) moves them onto a finer grid at no cost when serving. Every
decoder projection has an exact fold target, so the serving kernels (K7,
``ops/linear_int4``) are untouched:

- q/k/v: their input is ``RMSNorm(h) * input_ln.scale``, so input_ln's
  scale takes 1/s; gate/up likewise through post_ln;
- o: its input, the attention context, is linear in v_proj's output
  columns, so v_proj's columns take 1/s, with s shared across each GQA
  query-head group (kv-major);
- down: its input, silu(gate) * up, is linear in up, so up_proj's columns
  take 1/s.

Per site, s_j = (amax_j / gmean)^alpha, with alpha searched over
``DEFAULT_ALPHAS`` against the diagonal approximation of the output error,
sum_j E[x_j^2] * sum_k (W - dequant(W * s) / s)_jk^2, from one calibration
forward's statistics (``qwen3_vl.awq_taps``).

The trees are the JAX package's (``layer_i`` subtrees, ``kernel`` (in,
out)), with torch leaves (``params_to_jax`` of a state dict). Divergence
(ROADMAP.md Queue 3): the statistics, the search's errors and the folds
are computed where the weights lie, in f32 (on the card for the 8B: the
search's 36 layers x 4 sites x 5 alphas take minutes on a host); the
candidate scales stay in f64 numpy, as in JAX, so that a site's alpha does
not flip on the errors' summation order. The folded tree is quantized
by the port's int4 recipe (``models/quantize.quantize_qwen_text_params``),
one layer at a time, so the folded bf16 copy never exists whole.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from emr2a_tpu_torch.models.qwen3_vl import awq_taps

_SITES = ("qkv", "o", "gu", "down")
DEFAULT_ALPHAS = (0.0, 0.25, 0.5, 0.75, 1.0)


# ---------------------------------------------------------------------------
# Calibration statistics
# ---------------------------------------------------------------------------


@torch.inference_mode()
def collect_awq_stats(model, input_ids) -> Dict:
    """Calibration forwards of ``model`` (a ``Qwen3VLModel`` over its bf16
    params; JAX: ``collect_awq_stats(model, params, ...)``) and each decoder
    layer's statistics: {``layer_i``: {site: (amax (K,), mean square (K,))
    as np.float32}}. ``input_ids`` is one (B, S) int batch or an iterable of
    them; batches combine as the max of amax and the mean of the mean
    squares. Rope positions are arange(S) on all three axes, as in JAX."""
    batches = (input_ids,) if hasattr(input_ids, "shape") else tuple(input_ids)
    dev = model.language_model.final_ln.weight.device
    with awq_taps(model.language_model) as taps:
        for ids in batches:
            ids = torch.as_tensor(np.asarray(ids), dtype=torch.int64, device=dev)
            B, S = ids.shape
            pos = torch.arange(S, device=dev)[None, None].expand(3, B, S)
            model(ids, pos, return_hidden=True)
    out = {}
    for layer, per_site in taps.items():
        out[layer] = {}
        for site, stacks in per_site.items():
            arr = torch.stack(stacks).cpu().numpy()          # (n_batches, 2, K)
            out[layer][site] = (arr[:, 0].max(axis=0), arr[:, 1].mean(axis=0))
    return out


# ---------------------------------------------------------------------------
# Scale search
# ---------------------------------------------------------------------------


def _rtn_dequant(w: torch.Tensor, group: int) -> torch.Tensor:
    """Group-wise symmetric int4 round trip of an f32 (K, N) weight, the
    recipe's codes: scale = max(amax / 7, 1e-12), codes in [-7, 7]."""
    K, N = w.shape
    wg = w.reshape(K // group, group, N)
    amax = wg.abs().amax(dim=1, keepdim=True)
    scale = torch.clamp(amax / torch.full_like(amax, 7.0), min=1e-12)
    q = torch.clamp(torch.round(wg / scale), -7, 7)
    return (q * scale).reshape(K, N)


def _awq_site_err(w: torch.Tensor, s: torch.Tensor, msq: torch.Tensor,
                  group: int) -> torch.Tensor:
    """The diagonal-approximation output error of quantizing ``w`` with the
    fold ``s``, in f32 on ``w``'s device."""
    w = w.float()
    ws = w * s[:, None]
    deq = _rtn_dequant(ws, group) / s[:, None]
    return torch.sum(torch.square(deq - w) * msq[:, None])


def _candidate_scale(amax: np.ndarray, alpha: float) -> np.ndarray:
    a = np.maximum(amax.astype(np.float64), 1e-8)
    s = a ** alpha
    s = s / np.exp(np.mean(np.log(s)))      # gmean-normalized: alpha = 0 is RTN
    return np.clip(s, 1e-4, 1e4).astype(np.float32)


def _search_site(w: torch.Tensor, amax: np.ndarray, msq: np.ndarray, group: int) -> tuple:
    """The best (s, alpha, error, RTN error) of one (layer, site); alpha 0
    is RTN."""
    dev = w.device
    msq_t = torch.as_tensor(msq, device=dev)
    best = err_rtn = None
    for alpha in DEFAULT_ALPHAS:
        s = _candidate_scale(amax, alpha)
        err = float(_awq_site_err(w, torch.as_tensor(s, device=dev), msq_t, group))
        if alpha == 0.0:
            err_rtn = err
        if best is None or err < best[2]:
            best = (s, alpha, err)
    return best[0], best[1], best[2], err_rtn


def _site_weights(layer: Dict) -> Dict[str, torch.Tensor]:
    cat = lambda names: torch.cat([layer[p]["kernel"].float() for p in names], dim=1)
    return {"qkv": cat(("q_proj", "k_proj", "v_proj")),
            "o": layer["o_proj"]["kernel"].float(),
            "gu": cat(("gate_proj", "up_proj")),
            "down": layer["down_proj"]["kernel"].float()}


def compute_awq_scales(params: Dict, stats: Dict, num_heads: int, num_kv_heads: int,
                       head_dim: int) -> Dict:
    """Per-layer fold vectors {layer: {site: s, "alpha": {...}, "err":
    {site: {"awq", "rtn"}}}} for the un-quantized text subtree ``params``.
    The o-site scale is constant across each GQA query-head group (the
    worst amax, the mean of the mean squares, per (kv head, d)) so that it
    maps back onto v_proj's columns."""
    from emr2a_tpu_torch.ops.linear_int4 import int4_group
    groups_q = num_heads // num_kv_heads
    out = {}
    for layer_name, per_site in stats.items():
        weights = _site_weights(params[layer_name])
        entry = {"alpha": {}, "err": {}}
        for site in _SITES:
            amax, msq = per_site[site]
            if site == "o":
                a = amax.reshape(num_kv_heads, groups_q, head_dim)
                m = msq.reshape(num_kv_heads, groups_q, head_dim)
                amax = np.broadcast_to(a.max(axis=1, keepdims=True), a.shape).reshape(-1)
                msq = np.broadcast_to(m.mean(axis=1, keepdims=True), m.shape).reshape(-1)
            w = weights.pop(site)
            group = int4_group(w.shape[0])
            s, alpha, err, err_rtn = _search_site(w, amax, msq, group)
            del w
            entry[site] = s
            entry["alpha"][site] = alpha
            entry["err"][site] = {"awq": err, "rtn": err_rtn}
        out[layer_name] = entry
    return out


# ---------------------------------------------------------------------------
# Folding
# ---------------------------------------------------------------------------


def _scale_rows(entry: Dict, s: torch.Tensor) -> Dict:
    k = entry["kernel"]
    return {**entry, "kernel": (k.float() * s[:, None]).to(k.dtype)}


def _scale_cols(entry: Dict, inv_s: torch.Tensor) -> Dict:
    k = entry["kernel"]
    out = {**entry, "kernel": (k.float() * inv_s[None, :]).to(k.dtype)}
    if "bias" in entry:
        out["bias"] = (entry["bias"].float() * inv_s).to(entry["bias"].dtype)
    return out


def _scale_norm(entry: Dict, s: torch.Tensor) -> Dict:
    scale = entry["scale"]
    return {**entry, "scale": (scale.float() / s).to(scale.dtype)}


def fold_awq_scales(params: Dict, scales: Dict, num_kv_heads: int, head_dim: int) -> Dict:
    """The fold vectors applied to an un-quantized text subtree (output-
    preserving in exact arithmetic), on the weights' device; quantize
    afterwards with ``quantize_qwen_text_params(precision="int4")``."""
    out = dict(params)
    for layer_name, entry in scales.items():
        layer = dict(params[layer_name])
        dev = layer["o_proj"]["kernel"].device
        s_qkv, s_o, s_gu, s_down = (torch.as_tensor(np.asarray(entry[site]), device=dev)
                                    for site in _SITES)
        layer["input_ln"] = _scale_norm(layer["input_ln"], s_qkv)
        for p in ("q_proj", "k_proj", "v_proj"):
            layer[p] = _scale_rows(layer[p], s_qkv)
        # o: 1/s into v_proj's output columns (s is group-shared, so column
        # kv * hd + d takes the s of the group's first query head)
        s_o_v = s_o.reshape(num_kv_heads, -1, head_dim)[:, 0, :].reshape(-1)
        layer["v_proj"] = _scale_cols(layer["v_proj"], 1.0 / s_o_v)
        layer["o_proj"] = _scale_rows(layer["o_proj"], s_o)
        layer["post_ln"] = _scale_norm(layer["post_ln"], s_gu)
        for p in ("gate_proj", "up_proj"):
            layer[p] = _scale_rows(layer[p], s_gu)
        layer["up_proj"] = _scale_cols(layer["up_proj"], 1.0 / s_down)
        layer["down_proj"] = _scale_rows(layer["down_proj"], s_down)
        out[layer_name] = layer
    return out


def awq_quantize_qwen_text_params(model, full_params: Dict, calib_ids,
                                  return_report: bool = False):
    """The AWQ int4 pipeline in one call: calibrate, search, fold, quantize.
    ``model`` is a ``Qwen3VLModel`` over the bf16 weights of
    ``full_params`` (the whole tree, with torch leaves); returns the tree
    with its text subtree in W4A8 (and the per-layer alpha / error report).
    Each layer is folded and quantized in turn."""
    from emr2a_tpu_torch.models.quantize import quantize_qwen_text_params
    cfg = model.config.text
    text = full_params["language_model"]
    stats = collect_awq_stats(model, calib_ids)
    scales = compute_awq_scales(text, stats, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
    quant = dict(text)
    for name in scales:
        folded = fold_awq_scales({name: text[name]}, {name: scales[name]},
                                 cfg.num_kv_heads, cfg.head_dim)
        quant[name] = quantize_qwen_text_params(folded, precision="int4")[name]
    out = {**full_params, "language_model": quant}
    if return_report:
        report = {ln: {"alpha": e["alpha"], "err": e["err"]} for ln, e in scales.items()}
        return out, report
    return out
