"""K1 and K3 on the card, at shapes beyond the main path's: ragged token
counts, short and maximal sequences, valid_len edges, and the inputs the
wrappers must refuse. Each test skips without a CUDA card. On the card
(the suite's conftest imports JAX, which that machine lacks):

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q
"""

import pytest
import torch

from emr2a_tpu_torch.ops import attention_block, mlp


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card with sm_90a (H100)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rn(gen, *shape, std=1.0):
    return (torch.randn(*shape, generator=gen, device="cuda") * std).to(torch.bfloat16)


def _assert_matches(got, want):
    got = got.float().reshape(-1, got.shape[-1])
    want = want.float().reshape(-1, want.shape[-1])
    torch.testing.assert_close(got, want, atol=1e-2, rtol=1e-2)
    cos = torch.nn.functional.cosine_similarity(got, want, dim=-1)
    assert cos.min().item() >= 0.9999


def _mlp_args(gen, T, d, m):
    return (_rn(gen, T, d), (1 + _rn(gen, d, std=0.1).float()).to(torch.bfloat16),
            _rn(gen, d, std=0.1), _rn(gen, d, m, std=0.02), _rn(gen, m, std=0.02),
            _rn(gen, m, d, std=0.02), _rn(gen, d, std=0.02))


def _attn_args(gen, B, S, d):
    ws = [_rn(gen, d, d, std=0.02) if i % 2 == 0 else _rn(gen, d, std=0.02)
          for i in range(8)]
    return (_rn(gen, B, S, d), (1 + _rn(gen, d, std=0.1).float()).to(torch.bfloat16),
            _rn(gen, d, std=0.1), *ws)


@pytest.mark.parametrize("T,d,m", [(1, 768, 3072), (300, 768, 3072),
                                   (6437, 768, 3072), (129, 256, 512)])
def test_fused_ln_mlp_kernel_matches_plain(cuda, T, d, m):
    args = _mlp_args(torch.Generator(device="cuda").manual_seed(T), T, d, m)
    before = mlp.LAUNCHES
    got = mlp.fused_ln_mlp(*args)
    torch.cuda.synchronize()
    assert mlp.LAUNCHES == before + 1
    _assert_matches(got, mlp.fused_ln_mlp_reference(*args))


@pytest.mark.parametrize("B,S,d,H,valid_len", [
    (1, 17, 128, 2, 13), (3, 50, 768, 12, 50), (2, 200, 768, 12, 197),
    (1, 384, 256, 4, 300), (2, 8, 768, 12, 1),
])
def test_fused_ln_attention_kernel_matches_plain(cuda, B, S, d, H, valid_len):
    args = _attn_args(torch.Generator(device="cuda").manual_seed(S), B, S, d)
    before = attention_block.LAUNCHES
    got = attention_block.fused_ln_attention(*args, num_heads=H,
                                             valid_len=valid_len)
    torch.cuda.synchronize()
    assert attention_block.LAUNCHES == before + 1
    want = attention_block.fused_ln_attention_reference(
        *args, num_heads=H, valid_len=valid_len)
    _assert_matches(got[:, :valid_len], want[:, :valid_len])


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    gen = torch.Generator(device="cuda").manual_seed(0)
    x, s, b, *ws = _attn_args(gen, 1, 385, 256)
    with pytest.raises(ValueError, match="up to 384"):
        attention_block.fused_ln_attention(x, s, b, *ws, num_heads=4)
    x, s, b, *ws = _attn_args(gen, 1, 16, 768)
    with pytest.raises(ValueError, match="head dim 64"):
        attention_block.fused_ln_attention(x, s, b, *ws, num_heads=8)
    with pytest.raises(TypeError, match="bfloat16"):
        attention_block.fused_ln_attention(x.float(), s, b, *ws, num_heads=12)
    margs = list(_mlp_args(gen, 64, 256, 512))
    with pytest.raises(ValueError, match="contiguous"):
        mlp.fused_ln_mlp(margs[0], *margs[1:3], margs[3].t().contiguous().t(),
                         *margs[4:])
    with pytest.raises(ValueError, match="divisible by 128"):
        mlp.fused_ln_mlp(*_mlp_args(gen, 64, 192, 512))
    with pytest.raises(ValueError, match="gelu only"):
        mlp.fused_ln_mlp(*margs, activation="quick_gelu")
