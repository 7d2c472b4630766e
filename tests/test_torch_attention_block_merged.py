"""K3m, the merged-batch LN+attention block (``fused_ln_attention(...,
merge_batch=True)``), on the CPU, i.e. its plain version
``fused_ln_attention_merged_reference``, against the JAX package's Pallas
kernel ``_attn_block_kernel_merged`` in interpret mode on the same numpy
inputs, at the JAX test's cases (``tests/test_attention_block.py``: B = 5,
S = 197 / 200, d = 96, 6 heads, block_b 2 / 4, valid_len None / 197) at
K3's tolerance (f32: atol 2e-5, rtol 1e-4; bf16: atol = rtol = 1e-2), and
against K3's plain version, which it equals exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emr2a_tpu.ops.attention_block import (
    fused_ln_attention as jax_fused_ln_attention,
)
from emr2a_tpu_torch.ops import attention_block
from emr2a_tpu_torch.ops.attention_block import (
    fused_ln_attention,
    fused_ln_attention_merged_reference,
    fused_ln_attention_reference,
)

torch.set_num_threads(1)


def _inputs(rng, B, S, d):
    mk = lambda *sh: rng.randn(*sh) * 0.05
    return dict(x=rng.randn(B, S, d) * 0.5, ln_scale=rng.rand(d) + 0.5,
                ln_bias=mk(d), wq=mk(d, d), bq=mk(d), wk=mk(d, d), bk=mk(d),
                wv=mk(d, d), bv=mk(d), wo=mk(d, d), bo=mk(d))


@pytest.mark.parametrize("S", [197, 200])
@pytest.mark.parametrize("block_b", [2, 4])
@pytest.mark.parametrize("valid_len", [None, 197])
def test_merged_matches_jax_merged_kernel(rng, S, block_b, valid_len):
    a = [v.astype(np.float32) for v in _inputs(rng, 5, S, 96).values()]
    want = jax_fused_ln_attention(*(jnp.asarray(v) for v in a), num_heads=6,
                                  head_group=3, block_b=block_b,
                                  valid_len=valid_len, merge_batch=True,
                                  interpret=True)
    t = [torch.from_numpy(v) for v in a]
    got = fused_ln_attention(*t, num_heads=6, head_group=3, block_b=block_b,
                             valid_len=valid_len, merge_batch=True)
    n = S if valid_len is None else valid_len
    np.testing.assert_allclose(got.numpy()[:, :n], np.asarray(want)[:, :n],
                               atol=2e-5, rtol=1e-4)
    assert torch.equal(got, fused_ln_attention_reference(
        *t, num_heads=6, valid_len=valid_len))


def test_merged_bf16_matches_jax_merged_kernel(rng):
    a = [v.astype(np.float32) for v in _inputs(rng, 5, 200, 96).values()]
    want = jax_fused_ln_attention(
        *(jnp.asarray(v, jnp.bfloat16) for v in a), num_heads=6, head_group=6,
        block_b=2, valid_len=197, merge_batch=True, interpret=True)
    got = fused_ln_attention(*(torch.from_numpy(v).to(torch.bfloat16) for v in a),
                             num_heads=6, block_b=2, valid_len=197,
                             merge_batch=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy()[:, :197],
                               np.asarray(want, np.float32)[:, :197],
                               atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("B,block_b", [(5, 2), (5, 3), (7, 4), (3, 8), (4, 4),
                                       (1, 1), (6, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_merged_equals_k3_plain_exactly(rng, B, block_b, dtype):
    """Short last groups (B not a multiple of block_b) and block_b > B
    give K3's outputs exactly: the schedule moves no rounding point."""
    t = [torch.from_numpy(v.astype(np.float32)).to(dtype)
         for v in _inputs(rng, B, 40, 64).values()]
    got = fused_ln_attention_merged_reference(*t, num_heads=4, block_b=block_b,
                                              valid_len=37)
    assert torch.equal(got, fused_ln_attention_reference(*t, num_heads=4,
                                                         valid_len=37))


def test_head_group_and_block_b_without_merge_leave_k3(rng):
    t = [torch.from_numpy(v.astype(np.float32)) for v in _inputs(rng, 3, 33, 64).values()]
    want = fused_ln_attention_reference(*t, num_heads=4, valid_len=30)
    for kw in ({"head_group": 1}, {"head_group": 6, "block_b": 4}, {"block_b": 2}):
        assert torch.equal(fused_ln_attention(*t, num_heads=4, valid_len=30, **kw), want)


def test_merged_refuses_block_b_below_one_and_devices_without_a_kernel(rng):
    t = [torch.from_numpy(v.astype(np.float32)) for v in _inputs(rng, 2, 8, 64).values()]
    with pytest.raises(ValueError, match="block_b"):
        fused_ln_attention(*t, num_heads=2, block_b=0, merge_batch=True)
    with pytest.raises(ValueError, match="block_b"):
        fused_ln_attention_merged_reference(*t, num_heads=2, block_b=0)
    before = attention_block.MERGED_LAUNCHES
    with pytest.raises(ValueError, match="no kernel"):
        fused_ln_attention(*(v.to("meta") for v in t), num_heads=2, block_b=2,
                           merge_batch=True)
    assert attention_block.MERGED_LAUNCHES == before
