"""The port's W4A8 linear (K7) on the CPU, i.e. its plain version, and the
int4 / int8 weight recipes and the Qwen decoder quantizer, against the JAX
package on the same numpy inputs.

- ``quantize_weight_int4`` (numpy) and its torch twin give JAX's packed
  bytes and scales exactly, ties, zero columns and groups other than 128
  included; so does the int8 twin for ``quantize_weight_int8``.
- ``linear_w4a8_reference`` against ``linear_w4a8(..., interpret=True)`` at
  ``tests/test_linear_int4.py``'s cases and tolerance (rtol = atol = 1e-5:
  XLA may contract the group rescale into a fused multiply-add where the
  port rounds the product first).
- ``quantize_qwen_text_params`` trees byte-identical to JAX's, int8 and
  int4, with and without ``fuse_projs``, numpy and torch leaves.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emr2a_tpu.models.quantize import (
    quantize_qwen_text_params as jax_quantize_qwen_text_params,
)
from emr2a_tpu.ops.linear_int4 import linear_w4a8 as jax_linear_w4a8
from emr2a_tpu.ops.linear_int4 import quantize_weight_int4 as jax_quantize_weight_int4
from emr2a_tpu.ops.mlp import quantize_weight_int8 as jax_quantize_weight_int8
from emr2a_tpu_torch.models.quantize import (
    quantize_qwen_text_params,
    quantize_weight_int8_torch,
)
from emr2a_tpu_torch.ops import linear_int4

torch.set_num_threads(1)


def _weights(rng, K, N):
    w = (rng.randn(K, N) * 0.05).astype(np.float32)
    w[:, 3] = 0.0                                   # a zero column
    w[:4, 5] = [0.35, -0.35, 0.025, -0.075]         # near half-code ties
    w[4:, 5] = 0.01
    return w


@pytest.mark.parametrize("K,N,group", [(256, 128, 128), (512, 96, 128),
                                       (48, 16, 48), (96, 8, 32), (12, 6, 6)])
def test_quantize_weight_int4_bytes_equal_jax(rng, K, N, group):
    w = _weights(rng, K, N)
    want_p, want_s = jax_quantize_weight_int4(w, group=group)
    got_p, got_s = linear_int4.quantize_weight_int4(w, group=group)
    assert got_p.dtype == np.int8 and got_s.dtype == np.float32
    np.testing.assert_array_equal(got_p, want_p)
    np.testing.assert_array_equal(got_s, want_s)
    tp, ts = linear_int4.quantize_weight_int4_torch(torch.from_numpy(w), group=group)
    assert tp.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tp.numpy(), want_p)
    np.testing.assert_array_equal(ts.numpy(), want_s)
    # the plain version's unpack inverts the packing
    codes = linear_int4.unpack_int4(tp, group).numpy().astype(np.float32)
    deq = codes * np.repeat(want_s, group, axis=0)
    assert np.all(np.abs(w - deq) <= np.repeat(want_s, group, axis=0) / 2 + 1e-7)


def test_quantize_weight_int4_rejects_bad_group():
    with pytest.raises(ValueError):
        linear_int4.quantize_weight_int4(np.zeros((100, 8), np.float32), group=64)
    with pytest.raises(ValueError):
        linear_int4.quantize_weight_int4_torch(torch.zeros(100, 8), group=64)


def test_quantize_weight_int8_torch_equals_jax(rng):
    w = _weights(rng, 192, 64)
    w[:, 7] = 127 * 0.01 * np.sign(rng.randn(192))   # scale 0.01: exact ties
    want_q, want_s = jax_quantize_weight_int8(w)
    q, s = quantize_weight_int8_torch(torch.from_numpy(w))
    np.testing.assert_array_equal(q.numpy(), want_q)
    np.testing.assert_array_equal(s.numpy(), want_s)


@pytest.mark.parametrize("T,K,N,use_bias", [(4, 256, 128, True), (40, 256, 384, False),
                                            (1, 512, 256, True), (17, 128, 128, False)])
def test_linear_w4a8_matches_jax(rng, T, K, N, use_bias):
    x = (rng.randn(T, K) * 0.3).astype(np.float32)
    x[0] = 0.0                                       # an all-zero row
    w = (rng.randn(K, N) * 0.05).astype(np.float32)
    bias = (rng.randn(N) * 0.1).astype(np.float32) if use_bias else None
    w_p, w_s = jax_quantize_weight_int4(w, group=128)
    want = np.asarray(jax_linear_w4a8(
        jnp.asarray(x), jnp.asarray(w_p), jnp.asarray(w_s),
        None if bias is None else jnp.asarray(bias),
        out_dtype=jnp.float32, interpret=True))
    got = linear_int4.linear_w4a8(
        torch.from_numpy(x), torch.from_numpy(w_p), torch.from_numpy(w_s),
        None if bias is None else torch.from_numpy(bias), out_dtype=torch.float32)
    assert got.dtype == torch.float32 and got.shape == (T, N)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_linear_w4a8_leading_axes_and_small_groups(rng):
    x = (rng.randn(2, 3, 96) * 0.3).astype(np.float32)
    w = (rng.randn(96, 40) * 0.05).astype(np.float32)
    w_p, w_s = jax_quantize_weight_int4(w, group=32)
    want = np.asarray(jax_linear_w4a8(jnp.asarray(x), jnp.asarray(w_p),
                                      jnp.asarray(w_s), out_dtype=jnp.float32,
                                      interpret=True))
    got = linear_int4.linear_w4a8(torch.from_numpy(x), torch.from_numpy(w_p),
                                  torch.from_numpy(w_s), out_dtype=torch.float32)
    assert got.shape == (2, 3, 40)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_linear_w4a8_shape_validation(rng):
    w_p, w_s = linear_int4.quantize_weight_int4(rng.randn(256, 128).astype(np.float32))
    with pytest.raises(ValueError):
        linear_int4.linear_w4a8(torch.zeros(4, 512), torch.from_numpy(w_p),
                                torch.from_numpy(w_s))
    with pytest.raises(ValueError):
        linear_int4.linear_w4a8(torch.zeros(4, 256), torch.from_numpy(w_p),
                                torch.from_numpy(w_s[:1]).repeat(3, 1))


def test_int4_group_equals_jax():
    from emr2a_tpu.models.quantize import _int4_group
    for K in (6, 12, 48, 96, 100, 128, 4096, 12288, 4104):
        assert linear_int4.int4_group(K) == _int4_group(K)


def _qwen_layer_tree(rng, d=48, nq=48, nkv=24, inter=96, bias=False):
    def dense(n_in, n_out, b):
        e = {"kernel": (rng.randn(n_in, n_out) * 0.05).astype(np.float32)}
        if b:
            e["bias"] = (rng.randn(n_out) * 0.1).astype(np.float32)
        return e
    return {"input_ln": {"scale": np.ones(d, np.float32)},
            "post_ln": {"scale": np.ones(d, np.float32)},
            "q_proj": dense(d, nq, bias), "k_proj": dense(d, nkv, bias),
            "v_proj": dense(d, nkv, bias), "o_proj": dense(nq, d, bias),
            "q_norm_scale": np.ones(12, np.float32),
            "k_norm_scale": np.ones(12, np.float32),
            "gate_proj": dense(d, inter, False), "up_proj": dense(d, inter, False),
            "down_proj": dense(inter, d, False)}


def _assert_trees_equal(got, want, path=""):
    assert set(got) == set(want), (path, sorted(got), sorted(want))
    for key in want:
        g, w = got[key], want[key]
        if isinstance(w, dict):
            _assert_trees_equal(g, w, f"{path}/{key}")
        else:
            g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
            w = np.asarray(w)
            assert g.dtype == w.dtype and g.shape == w.shape, (path, key)
            np.testing.assert_array_equal(g, w, err_msg=f"{path}/{key}")


@pytest.mark.parametrize("precision", ["int8", "int4"])
@pytest.mark.parametrize("fuse_projs", [False, True])
@pytest.mark.parametrize("leaves", ["numpy", "torch"])
def test_quantize_qwen_text_params_trees_equal_jax(rng, precision, fuse_projs, leaves):
    tree = {"layer_0": _qwen_layer_tree(rng, bias=True), "layer_1": _qwen_layer_tree(rng),
            "embed_tokens": {"embedding": rng.randn(50, 48).astype(np.float32)},
            "final_ln": {"scale": np.ones(48, np.float32)},
            "lm_head": {"kernel": rng.randn(48, 50).astype(np.float32)}}
    want = jax_quantize_qwen_text_params(tree, lm_head_int8=True, precision=precision,
                                         fuse_projs=fuse_projs)
    if leaves == "torch":
        tree = {k: {kk: ({a: torch.from_numpy(b) for a, b in vv.items()}
                         if isinstance(vv, dict) else torch.from_numpy(vv))
                    for kk, vv in v.items()} for k, v in tree.items()}
    got = quantize_qwen_text_params(tree, lm_head_int8=True, precision=precision,
                                    fuse_projs=fuse_projs)
    _assert_trees_equal(got, want)
    with pytest.raises(ValueError):
        quantize_qwen_text_params(tree, precision="int2")
