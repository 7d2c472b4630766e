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


# -- K3m's group on the card (``merged_group``), a pure function -------------

H100_SMS, H100_L2 = 132, 50 * 2**20


def _tiles(G, S, d):
    return -(-G * S // 128) * (d // 128)


def _scratch(G, S, d):
    return 4 * G * S * d * 2


@pytest.mark.parametrize("S,d", [(197, 768), (200, 768), (577, 768), (40, 256)])
@pytest.mark.parametrize("block_b", [1, 2, 3, 4, 8, 64])
def test_merged_group_rule(S, d, block_b):
    """The group is a multiple of block_b and at most B (all of B where B
    <= block_b), its scratch within the stated share of L2 unless it is one
    block_b, and the least such multiple whose out-projection covers the
    SMs MERGED_WAVES times where B and L2 allow one."""
    share = attention_block.MERGED_L2_SHARE * H100_L2
    fill = attention_block.MERGED_WAVES * H100_SMS
    for B in (1, 2, 3, 5, 8, 13, 16, 32, 37, 96, 128, 200):
        G = attention_block.merged_group(B, S, d, block_b, H100_SMS, H100_L2)
        assert 1 <= G <= B
        if B <= block_b:
            assert G == B
            continue
        assert G % block_b == 0
        assert G == block_b or _scratch(G, S, d) <= share
        if G > block_b:       # the least multiple that fills the SMs
            assert _tiles(G - block_b, S, d) < fill
        if _tiles(G, S, d) < fill:       # stopped short: B or L2 forbid more
            assert G + block_b > B or _scratch(G + block_b, S, d) > share


def test_merged_group_at_vit_b():
    """ViT-B at block_b 4: 24 items, 38 x 6 = 228 out-projection tiles for
    1.5 waves on 132 SMs, about 29 MB of scratch; one wave is 16 items (25 x
    6 = 150 tiles, about 20 MB); a smaller L2 or SM count takes fewer."""
    assert (attention_block.MERGED_WAVES, attention_block.MERGED_L2_SHARE) == (1.5, 0.6)
    assert attention_block.merged_group(32, 200, 768, 4, H100_SMS, H100_L2) == 24
    assert attention_block.merged_group(128, 197, 768, 4, H100_SMS, H100_L2) == 24
    assert attention_block.merged_group(128, 200, 768, 4, H100_SMS, H100_L2, waves=1.0) == 16
    assert _scratch(24, 200, 768) == 29_491_200 and _scratch(16, 200, 768) == 19_660_800
    assert attention_block.merged_group(128, 200, 768, 4, 66, H100_L2) == 12
    assert attention_block.merged_group(128, 200, 768, 4, H100_SMS, 20 * 2**20) == 8
    assert attention_block.merged_group(3, 200, 768, 4, H100_SMS, H100_L2) == 3
    assert attention_block.merged_group(37, 200, 768, 4, H100_SMS, H100_L2) == 24
    assert attention_block.merged_group(20, 200, 768, 4, H100_SMS, H100_L2) == 20
    with pytest.raises(ValueError, match="block_b"):
        attention_block.merged_group(4, 200, 768, 0, H100_SMS, H100_L2)


@pytest.mark.parametrize("B,block_b", [(37, 4), (3, 4), (32, 16)])
def test_merged_plain_version_equals_k3_at_card_groups(rng, B, block_b):
    """The plain version at the card's group (the rule's G as its block_b)
    equals K3's plain version exactly."""
    t = [torch.from_numpy(v.astype(np.float32)).to(torch.bfloat16)
         for v in _inputs(rng, B, 12, 128).values()]
    G = attention_block.merged_group(B, 12, 128, block_b, H100_SMS, H100_L2)
    got = fused_ln_attention_merged_reference(*t, num_heads=2, block_b=G, valid_len=10)
    assert torch.equal(got, fused_ln_attention_reference(*t, num_heads=2, valid_len=10))
