"""The kernels on the card, at shapes beyond the main path's: K1 and K3
(bf16) and K2, K4, K5 (W8A8) at ragged token counts including T = 1 and
T < 32, short and maximal sequences, valid_len edges, all-zero rows, the
row quantize's codes; K6 (the fused cosine top-k, f32, bf16 and int8) at
ragged row counts, n_valid < n, k = 1 to 1000, several query counts and
widths, and duplicated rows, on both of its scans (the tile scan forced
at every q); K7 (the W4A8 linear) and K5 at T = 1 to
8,192 on both of their designs (GEMV up to 16 rows, one launch with the row
quantize inside, by the kernel library's own launch counts; the wgmma
GEMM above), K = 12,288 with N = 1,024, duplicate and all-zero rows, leading
axes, and the card's int4 quantizer against the numpy one; K8 and
K9 (the per-frame attention kernel) at ragged S, head dims 8 to 128 and
duplicate keys; K3 and K4 at S = 385 and 577 (the attention core's
streamed K/V) and at valid_len 256 and 257 (its last resident and first
streamed key count); K3m (the merged-batch LN+attention block) bit for bit
against K3 at B = 1, 5, 128 and block_b 1, 3, 4, 8, at valid_len < S, S = 1,
S = 384 and S = 577, and on its card schedule (the group from the SM count
and L2 size, on two streams or one) at (32, 200), (96, 200), (128, 197),
(2, 577), B = 37 and B < block_b, also replayed in a CUDA graph; K1 and K2 with act_dtype=bf16
and with CLIP's quick_gelu (K2 at ViT-L/14-336's width, d = 1,024, m =
4,096; its epilogues against their device functions); K2's and K4's s8
products (the persistent s8 wgmma GEMM) bit for bit against torch._int_mm
on the codes and scales the kernels leave in their scratch, at T = 1 to
6,437, at K4's edge shapes and at ViT-L/14-336's (8, 584, 1,024), 16 heads,
valid_len 577; the inputs the wrappers must
refuse, and the launch counters. Each test skips without a CUDA card. On the card (the suite's
conftest imports JAX, which that machine lacks):

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q

Tolerances: K1 to K4 against their plain versions at atol = rtol = 1e-2
and row cosine >= 0.9999 (bf16 outputs; K2 and K4 may flip a rare code
where an f32 LN or activation value lands on a rounding boundary in
another summation order). K5 and the row quantize have no such value:
their codes, sums and rescale are the plain version's exactly, so they are
held bit for bit. K6: the int8 variant is bit-identical (exact s32 sums,
then the same two rounded multiplies); in f32 and bf16 the values agree
within 1e-5 (f32 sums in another order) and an index may differ only where
the plain version scores the two rows within 1e-5 of each other. K7 is
bit-identical too (exact s32 group sums, the same rounded rescale in group
order). K8 and K9 round unnormalised probabilities to bf16 where the plain
version rounds normalised ones: atol = rtol = 1e-2 and row cosine >= 0.9999.
"""

import pytest
import torch

from emr2a_tpu_torch.ops import (attention, attention_block, linear_int4, linear_int8,
                                 mlp, quant, topk, vision_flash)


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
                                   (6437, 768, 3072), (129, 256, 512),
                                   (77, 128, 2176)])
def test_fused_ln_mlp_kernel_matches_plain(cuda, T, d, m):
    args = _mlp_args(torch.Generator(device="cuda").manual_seed(T), T, d, m)
    before = mlp.LAUNCHES
    got = mlp.fused_ln_mlp(*args)
    torch.cuda.synchronize()
    assert mlp.LAUNCHES == before + 1
    _assert_matches(got, mlp.fused_ln_mlp_reference(*args))


@pytest.mark.parametrize("B,S,d,H,valid_len", [
    (1, 17, 128, 2, 13), (3, 50, 768, 12, 50), (2, 200, 768, 12, 197),
    (1, 384, 256, 4, 300), (2, 8, 768, 12, 1), (1, 385, 256, 4, 300),
    (2, 577, 768, 12, 570), (2, 260, 256, 4, 256), (2, 260, 256, 4, 257),
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
    with pytest.raises(ValueError, match="only, got 'silu'"):
        mlp.fused_ln_mlp(*margs, activation="silu")


# -- K3m: the merged-batch schedule of K3 ------------------------------------

@pytest.mark.parametrize("B", [1, 5, 128])
@pytest.mark.parametrize("block_b", [1, 3, 4, 8])
def test_merged_attention_kernel_equals_k3_bit_for_bit(cuda, B, block_b):
    args = _attn_args(torch.Generator(device="cuda").manual_seed(B), B, 197, 768)
    before = attention_block.MERGED_LAUNCHES, attention_block.LAUNCHES
    got = attention_block.fused_ln_attention(*args, num_heads=12, valid_len=197,
                                             block_b=block_b, merge_batch=True)
    torch.cuda.synchronize()
    assert (attention_block.MERGED_LAUNCHES, attention_block.LAUNCHES) == \
        (before[0] + 1, before[1])
    want = attention_block.fused_ln_attention(*args, num_heads=12, valid_len=197)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    if B == 5:
        _assert_matches(got, attention_block.fused_ln_attention_merged_reference(
            *args, num_heads=12, valid_len=197, block_b=block_b))


@pytest.mark.parametrize("B,S,d,H,valid_len,block_b", [
    (6, 200, 768, 12, 150, 4), (5, 1, 768, 12, 1, 2), (3, 384, 256, 4, 384, 2),
    (4, 384, 768, 12, 300, 3), (3, 577, 768, 12, 570, 2)])
def test_merged_attention_kernel_edges(cuda, B, S, d, H, valid_len, block_b):
    args = _attn_args(torch.Generator(device="cuda").manual_seed(S + B), B, S, d)
    got = attention_block.fused_ln_attention(*args, num_heads=H, valid_len=valid_len,
                                             block_b=block_b, merge_batch=True)
    torch.cuda.synchronize()
    want = attention_block.fused_ln_attention(*args, num_heads=H, valid_len=valid_len)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    _assert_matches(got[:, :valid_len], attention_block.fused_ln_attention_merged_reference(
        *args, num_heads=H, valid_len=valid_len, block_b=block_b)[:, :valid_len])


@pytest.mark.parametrize("B,S,valid_len,block_b", [
    (32, 200, 197, 4), (96, 200, 197, 4), (128, 197, 197, 4), (2, 577, 570, 4),
    (37, 200, 197, 4), (3, 200, 197, 4), (37, 200, 197, 1)])
@pytest.mark.parametrize("streams", [2, 1])
def test_merged_schedule_on_the_card_equals_k3_bit_for_bit(cuda, monkeypatch, B, S,
                                                            valid_len, block_b, streams):
    """K3m's card schedule (the rule's group from this card's SM count and L2
    size, groups alternating on two streams, or on one) at the main path's
    shapes, a B that is not a multiple of the group, and B < block_b."""
    if streams == 1:       # every group on the current stream
        monkeypatch.setattr(attention_block, "_side_stream", lambda current: current)
    args = _attn_args(torch.Generator(device="cuda").manual_seed(B + S), B, S, 768)
    G = attention_block.merged_group(B, S, 768, block_b,
                                     *attention_block.device_caps(torch.cuda.current_device()))
    assert G == B if B <= block_b else G % block_b == 0
    got = attention_block.fused_ln_attention(*args, num_heads=12, valid_len=valid_len,
                                             block_b=block_b, merge_batch=True)
    want = attention_block.fused_ln_attention(*args, num_heads=12, valid_len=valid_len)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("B", [32, 37])
def test_merged_schedule_replays_in_a_cuda_graph(cuda, B):
    """The fork into the side stream and the join back are captured in a
    CUDA graph; replays on new inputs equal K3 bit for bit."""
    gen = torch.Generator(device="cuda").manual_seed(B)
    x, *rest = _attn_args(gen, B, 200, 768)
    run = lambda: attention_block.fused_ln_attention(x, *rest, num_heads=12, valid_len=197,
                                                     block_b=4, merge_batch=True)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = run()
    for _ in range(2):
        x.copy_(_rn(gen, B, 200, 768))
        graph.replay()
        want = attention_block.fused_ln_attention(x, *rest, num_heads=12, valid_len=197)
        torch.cuda.synchronize()
        assert torch.equal(out, want)


def test_merged_attention_refuses_what_the_kernel_does_not_take(cuda):
    gen = torch.Generator(device="cuda").manual_seed(1)
    before = attention_block.MERGED_LAUNCHES
    x, s, b, *ws = _attn_args(gen, 2, 16, 768)
    with pytest.raises(ValueError, match="block_b"):
        attention_block.fused_ln_attention(x, s, b, *ws, num_heads=12, block_b=0,
                                           merge_batch=True)
    with pytest.raises(ValueError, match="head dim 64"):
        attention_block.fused_ln_attention(x, s, b, *ws, num_heads=8, block_b=2,
                                           merge_batch=True)
    with pytest.raises(TypeError, match="bfloat16"):
        attention_block.fused_ln_attention(x.float(), s, b, *ws, num_heads=12,
                                           block_b=2, merge_batch=True)
    x, s, b, *ws = _attn_args(gen, 1, 16, 192)
    with pytest.raises(ValueError, match="divisible by 128"):
        attention_block.fused_ln_attention(x, s, b, *ws, num_heads=3, block_b=2,
                                           merge_batch=True)
    assert attention_block.MERGED_LAUNCHES == before


# -- K1 and K2 with act_dtype=bf16 -------------------------------------------

@pytest.mark.parametrize("T", [1, 300, 6400])
def test_act_bf16_kernels_match_plain(cuda, T):
    gen = torch.Generator(device="cuda").manual_seed(T)
    args = _mlp_args(gen, T, 768, 3072)
    before = mlp.LAUNCHES
    got = mlp.fused_ln_mlp(*args, act_dtype=torch.bfloat16, tile=256)
    torch.cuda.synchronize()
    assert mlp.LAUNCHES == before + 1
    _assert_matches(got, mlp.fused_ln_mlp_reference(*args, act_dtype=torch.bfloat16))
    assert torch.equal(mlp.fused_ln_mlp(*args, act_dtype=torch.float32), mlp.fused_ln_mlp(*args))
    args8 = _mlp8_args(gen, T, 768, 3072)
    before = mlp.INT8_LAUNCHES
    got = mlp.fused_ln_mlp_int8(*args8, act_dtype=torch.bfloat16, tile=256)
    torch.cuda.synchronize()
    assert mlp.INT8_LAUNCHES == before + 1
    _assert_matches(got, mlp.fused_ln_mlp_int8_reference(*args8, act_dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="act_dtype"):
        mlp.fused_ln_mlp_int8(*args8, act_dtype=torch.float16)


def test_act_bf16_gelu_epilogues_equal_gelu_tanh_bf16_bit_for_bit(cuda):
    """The kernel entries with fc1 weights zero and b1 = the values, so that
    the h1 scratch is the epilogue's gelu of b1: K1's (bf16) and K2's (f32)
    equal ``gelu_tanh_bf16`` exactly with act_bf16 and differ without."""
    import ctypes

    import numpy as np

    from emr2a_tpu_torch.ops import _build
    T, d, m, bf = 4, 128, 400_000, torch.bfloat16
    v = torch.from_numpy((np.random.RandomState(3).randn(m) * 3).astype(np.float32)).to(bf)
    want = mlp.gelu_tanh_bf16(v.float())
    x = _rn(torch.Generator(device="cuda").manual_seed(0), T, d)
    ln_s, ln_b = torch.ones(d, device=cuda, dtype=bf), torch.zeros(d, device=cuda, dtype=bf)
    b1, b2 = v.to(cuda), torch.zeros(d, device=cuda, dtype=bf)
    stream = torch.cuda.current_stream().cuda_stream
    p, i = ctypes.c_void_p, ctypes.c_int
    ptrs = lambda *ts: [t.data_ptr() for t in ts]
    k1 = _build.kernel_function("emr2a_fused_ln_mlp", mlp._argtypes())
    k2 = _build.kernel_function("emr2a_fused_ln_mlp_int8",
                                [p] * 15 + [i, i, i, i, ctypes.c_float, p])
    w1, w2 = torch.zeros(d, m, device=cuda, dtype=bf), torch.zeros(m, d, device=cuda, dtype=bf)
    w1q, w2q = w1.to(torch.int8), w2.to(torch.int8)
    w1s, w2s = torch.ones(m, device=cuda), torch.ones(d, device=cuda)
    got = {}
    for act_bf16 in (1, 0):
        h1, h1_8 = torch.empty(T, m, device=cuda, dtype=bf), torch.empty(T, m, device=cuda)
        _build.check(k1(*ptrs(x, ln_s, ln_b, w1, b1, w2, b2, h1, torch.empty_like(x)),
                        T, d, m, act_bf16, 1e-6, stream), "fused_ln_mlp")
        scratch = (torch.empty(T, d, device=cuda, dtype=torch.int8),
                   torch.empty(T, device=cuda), h1_8,
                   torch.empty(T, m, device=cuda, dtype=torch.int8),
                   torch.empty(T, device=cuda), torch.empty_like(x))
        _build.check(k2(*ptrs(x, ln_s, ln_b, w1q, w1s, b1, w2q, w2s, b2, *scratch),
                        T, d, m, act_bf16, 1e-6, stream), "fused_ln_mlp_int8")
        torch.cuda.synchronize()
        got[act_bf16] = (h1.cpu(), h1_8.cpu())
    assert torch.equal(got[1][0], want.to(bf).expand(T, m))
    assert torch.equal(got[1][1], want.expand(T, m))
    assert not torch.equal(got[0][0], got[1][0])
    assert not torch.equal(got[0][1], got[1][1])


# -- K1 and K2 with CLIP's quick_gelu ---------------------------------------

@pytest.mark.parametrize("act_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [1, 300, 6400])
def test_quick_gelu_kernels_match_plain(cuda, T, act_dtype):
    """K1 at CLIP ViT-B/16's width and K2 at ViT-L/14-336's, with
    ``activation="quick_gelu"``, against their plain versions."""
    gen = torch.Generator(device="cuda").manual_seed(T + 11)
    args = _mlp_args(gen, T, 768, 3072)
    before = mlp.LAUNCHES
    got = mlp.fused_ln_mlp(*args, activation="quick_gelu", act_dtype=act_dtype)
    torch.cuda.synchronize()
    assert mlp.LAUNCHES == before + 1
    _assert_matches(got, mlp.fused_ln_mlp_reference(*args, activation="quick_gelu",
                                                     act_dtype=act_dtype))
    assert not torch.equal(got, mlp.fused_ln_mlp(*args, act_dtype=act_dtype))
    args8 = _mlp8_args(gen, T, 1024, 4096)
    before = mlp.INT8_LAUNCHES
    got = mlp.fused_ln_mlp_int8(*args8, activation="quick_gelu", act_dtype=act_dtype)
    torch.cuda.synchronize()
    assert mlp.INT8_LAUNCHES == before + 1
    _assert_matches(got, mlp.fused_ln_mlp_int8_reference(*args8, activation="quick_gelu",
                                                          act_dtype=act_dtype))


def test_quick_gelu_epilogues_equal_their_device_functions(cuda):
    """As the gelu check above, with the quick_gelu flag: K1's and K2's bf16
    epilogues equal ``quick_gelu_bf16``'s device function
    (``emr2a_activation_values``) bit for bit, and the plain version within
    one bf16 ulp; the f32 epilogues within 2^-20 of ``x *
    torch.sigmoid(1.702 x)`` (the accurate expf, a division)."""
    import ctypes

    import numpy as np

    from emr2a_tpu_torch.ops import _build
    T, d, m, bf = 4, 128, 400_000, torch.bfloat16
    v = torch.from_numpy((np.random.RandomState(3).randn(m) * 3).astype(np.float32)).to(bf)
    x = _rn(torch.Generator(device="cuda").manual_seed(0), T, d)
    ln_s, ln_b = torch.ones(d, device=cuda, dtype=bf), torch.zeros(d, device=cuda, dtype=bf)
    b1, b2 = v.to(cuda), torch.zeros(d, device=cuda, dtype=bf)
    stream = torch.cuda.current_stream().cuda_stream
    p, i = ctypes.c_void_p, ctypes.c_int
    ptrs = lambda *ts: [t.data_ptr() for t in ts]
    k1 = _build.kernel_function("emr2a_fused_ln_mlp", mlp._argtypes())
    k2 = _build.kernel_function("emr2a_fused_ln_mlp_int8",
                                [p] * 15 + [i, i, i, i, ctypes.c_float, p])
    values = _build.kernel_function("emr2a_activation_values", [p, p, i, i, p])
    w1, w2 = torch.zeros(d, m, device=cuda, dtype=bf), torch.zeros(m, d, device=cuda, dtype=bf)
    w1q, w2q = w1.to(torch.int8), w2.to(torch.int8)
    w1s, w2s = torch.ones(m, device=cuda), torch.ones(d, device=cuda)
    for act in (3, 2):
        h1, h1_8 = torch.empty(T, m, device=cuda, dtype=bf), torch.empty(T, m, device=cuda)
        _build.check(k1(*ptrs(x, ln_s, ln_b, w1, b1, w2, b2, h1, torch.empty_like(x)),
                        T, d, m, act, 1e-6, stream), "fused_ln_mlp")
        scratch = (torch.empty(T, d, device=cuda, dtype=torch.int8),
                   torch.empty(T, device=cuda), h1_8,
                   torch.empty(T, m, device=cuda, dtype=torch.int8),
                   torch.empty(T, device=cuda), torch.empty_like(x))
        _build.check(k2(*ptrs(x, ln_s, ln_b, w1q, w1s, b1, w2q, w2s, b2, *scratch),
                        T, d, m, act, 1e-6, stream), "fused_ln_mlp_int8")
        device_fn = torch.empty(m, device=cuda)
        vf = b1.float()
        _build.check(values(vf.data_ptr(), device_fn.data_ptr(), m, act, stream),
                     "activation_values")
        torch.cuda.synchronize()
        if act == 3:
            assert torch.equal(h1, device_fn.to(bf).expand(T, m))
            assert torch.equal(h1_8, device_fn.expand(T, m))
            plain = mlp.quick_gelu_bf16(vf)
            torch.testing.assert_close(device_fn, plain, rtol=2 ** -7, atol=2 ** -20)
        else:
            plain = vf * torch.sigmoid(1.702 * vf)
            torch.testing.assert_close(h1_8, plain.expand(T, m), rtol=2 ** -20, atol=2 ** -20)
            torch.testing.assert_close(h1.float(), plain.to(bf).float().expand(T, m),
                                       rtol=2 ** -7, atol=2 ** -20)


# -- W8A8: the row quantize, K5, K2, K4 ------------------------------------

def _w8(gen, K, N, std=0.02):
    """int8 codes and column scales of bf16 weights, as fast="int8" makes
    them."""
    w = _rn(gen, K, N, std=std).float().cpu().numpy()
    q, scale = mlp.quantize_weight_int8(w)
    return torch.from_numpy(q).cuda(), torch.from_numpy(scale.reshape(-1)).cuda()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows,K", [(1, 768), (37, 3072), (6400, 768)])
def test_quantize_rows_codes_equal_plain(cuda, dtype, rows, K):
    gen = torch.Generator(device="cuda").manual_seed(rows)
    x = (torch.randn(rows, K, generator=gen, device="cuda")
         * torch.exp(torch.randn(rows, 1, generator=gen, device="cuda") * 2)).to(dtype)
    x[0, :] = 0.0
    before = quant.LAUNCHES
    q, s = quant.quantize_rows_s8(x)
    torch.cuda.synchronize()
    assert quant.LAUNCHES == before + 1
    want_q, want_s = quant.quantize_rows_s8_reference(x)
    assert torch.equal(q, want_q) and torch.equal(s, want_s)
    assert (q[0] == 0).all()


# K5's and K7's two designs: the GEMV up to 16 rows (one launch, the rows
# quantized inside it), the wgmma GEMM above; K = 160 leaves a partial
# 128-deep stage (TMA's zero fill) and a partial GEMV segment
@pytest.mark.parametrize("T,K,N", [(1, 768, 768), (2, 768, 3072), (7, 768, 3072),
                                   (15, 3072, 768), (16, 4096, 1024), (17, 768, 768),
                                   (31, 3072, 768), (300, 768, 3072), (1100, 4096, 1024),
                                   (2048, 4096, 4096), (8192, 3072, 3072), (1, 12288, 1024),
                                   (16, 12288, 1024), (1, 4096, 12288), (3, 160, 256),
                                   (40, 160, 256),
                                   # the encoder zoo's: DINOv3 ViT-L at 16 x 201 tokens,
                                   # CLIP ViT-L/14-336's vision at 8 x 584, its text at 8 x 77
                                   (3216, 1024, 1024), (3216, 1024, 4096), (3216, 4096, 1024),
                                   (4672, 1024, 1024), (616, 768, 768), (616, 768, 3072),
                                   (616, 3072, 768)])
@pytest.mark.parametrize("use_bias", [True, False])
def test_linear_w8a8_kernel_equals_plain(cuda, T, K, N, use_bias):
    gen = torch.Generator(device="cuda").manual_seed(T + K)
    x = _rn(gen, T, K)
    if T > 2:
        x[1] = x[0]                      # duplicate rows give identical outputs
        x[2] = 0.0                       # an all-zero row
    wq, ws = _w8(gen, K, N)
    b = _rn(gen, N, std=0.02) if use_bias else None
    before = linear_int8.LAUNCHES
    got = linear_int8.linear_w8a8(x, wq, ws, b)
    torch.cuda.synchronize()
    assert linear_int8.LAUNCHES == before + 1
    want = linear_int8.linear_w8a8_reference(x, wq, ws, b)
    assert got.dtype == torch.bfloat16 and got.shape == (T, N)
    assert torch.equal(got, want), (got.float() - want.float()).abs().max()
    if T > 2:
        assert torch.equal(got[0], got[1])
    stream = torch.cuda.current_stream().cuda_stream
    assert not linear_int8.workspace(x.device, stream, 0, N // 128)[1].any()   # left at zero


@pytest.mark.parametrize("T", [1, 16, 17, 256])
def test_linear_w8a8_leading_axes_and_zero_rows(cuda, T):
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = _rn(gen, 4, T, 768)
    x[1, T - 1] = 0.0
    wq, ws = _w8(gen, 768, 768)
    b = _rn(gen, 768, std=0.02)
    got = linear_int8.linear_w8a8(x, wq, ws, b)
    torch.cuda.synchronize()
    assert got.shape == (4, T, 768)
    assert torch.equal(got, linear_int8.linear_w8a8_reference(x, wq, ws, b))
    assert torch.equal(got[1, T - 1], b)


@pytest.mark.parametrize("kind", ["w8a8", "w4a8"])
def test_quantized_linears_launch_once_up_to_16_rows(cuda, kind):
    gen = torch.Generator(device="cuda").manual_seed(9)
    K, N = 4096, 1024
    w, ws = _w8(gen, K, N) if kind == "w8a8" else _w4(gen, K, N)
    op = linear_int8.linear_w8a8 if kind == "w8a8" else linear_int4.linear_w4a8
    gemv, gemm = f"linear_{kind} GEMV", f"linear_{kind} wgmma GEMM"
    for T, want in ((1, {gemv: 1}), (16, {gemv: 1}), (17, {"row quantize": 1, gemm: 1})):
        x = _rn(gen, T, K)
        before = linear_int8.device_launches()
        op(x, w, ws)
        torch.cuda.synchronize()
        after = linear_int8.device_launches()
        launched = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        assert launched == want, (T, launched)


def _mlp8_args(gen, T, d, m):
    x, s, b = _rn(gen, T, d), (1 + _rn(gen, d, std=0.1).float()).to(torch.bfloat16), \
        _rn(gen, d, std=0.1)
    w1q, w1s = _w8(gen, d, m)
    w2q, w2s = _w8(gen, m, d)
    return x, s, b, w1q, w1s, _rn(gen, m, std=0.02), w2q, w2s, _rn(gen, d, std=0.02)


@pytest.mark.parametrize("T,d,m", [(1, 768, 3072), (7, 768, 3072), (300, 768, 3072),
                                   (6437, 768, 3072), (129, 256, 512), (4672, 1024, 4096)])
def test_fused_ln_mlp_int8_kernel_matches_plain(cuda, T, d, m):
    args = _mlp8_args(torch.Generator(device="cuda").manual_seed(T), T, d, m)
    args[0][0] = 0.0                                    # an all-zero row
    before = mlp.INT8_LAUNCHES
    got = mlp.fused_ln_mlp_int8(*args)
    torch.cuda.synchronize()
    assert mlp.INT8_LAUNCHES == before + 1
    assert torch.isfinite(got).all()
    _assert_matches(got, mlp.fused_ln_mlp_int8_reference(*args))


def _attn8_args(gen, B, S, d):
    ws = []
    for _ in range(4):
        ws += [*_w8(gen, d, d), _rn(gen, d, std=0.02)]
    return (_rn(gen, B, S, d), (1 + _rn(gen, d, std=0.1).float()).to(torch.bfloat16),
            _rn(gen, d, std=0.1), *ws)


@pytest.mark.parametrize("B,S,d,H,valid_len", [
    (1, 17, 128, 2, 13), (3, 50, 768, 12, 50), (32, 200, 768, 12, 197),
    (1, 384, 256, 4, 300), (2, 8, 768, 12, 1), (1, 385, 256, 4, 300),
    (2, 577, 768, 12, 570), (2, 260, 256, 4, 257), (8, 584, 1024, 16, 577),
])
def test_fused_ln_attention_int8_kernel_matches_plain(cuda, B, S, d, H, valid_len):
    args = _attn8_args(torch.Generator(device="cuda").manual_seed(S), B, S, d)
    args[0][:, S - 1] = 0.0                            # all-zero (padding) rows
    before = attention_block.INT8_LAUNCHES
    got = attention_block.fused_ln_attention_int8(*args, num_heads=H,
                                                  valid_len=valid_len)
    torch.cuda.synchronize()
    assert attention_block.INT8_LAUNCHES == before + 1
    assert torch.isfinite(got).all()
    want = attention_block.fused_ln_attention_int8_reference(
        *args, num_heads=H, valid_len=valid_len)
    _assert_matches(got[:, :valid_len], want[:, :valid_len])


# K2's and K4's s8 products run on the persistent s8 wgmma GEMM
# (csrc/gemm_s8_wgmma.cuh): exact s32 sums and the same three rounded
# steps, so each product equals torch._int_mm on the kernel's own codes
# and scales (read back from its scratch), rescaled in plain PyTorch, bit
# for bit; K2's f32 gelu of fc1 within a few ulp of PyTorch's. Their LN
# codes and scales equal the plain version's bit for bit.

def _int_mm(a, w):
    """(M, K) int8 @ (K, N) int8 -> (M, N) s32 exactly, on torch._int_mm
    (cuBLAS int8; it takes more than 16 rows, so short ones are padded)."""
    M = a.shape[0]
    if M <= 16:
        a = torch.cat([a, a.new_zeros(32 - M, a.shape[1])])
    return torch._int_mm(a, w.t().contiguous().t())[:M]


def _rescale(acc, row_scale, w_scale, bias):
    """bf16(((f32(acc) * row scale) * column scale) + bias), each step
    rounded once."""
    y = acc.float() * row_scale.reshape(-1, 1)
    y = y * w_scale.reshape(1, -1)
    return (y + bias.float()).to(torch.bfloat16)


@pytest.mark.parametrize("act_bf16", [0, 1, 2, 3])     # the kernel's flags: 2 = quick_gelu
@pytest.mark.parametrize("T,d,m", [(1, 768, 3072), (7, 768, 3072), (300, 768, 3072),
                                   (6437, 768, 3072), (129, 256, 512), (4672, 1024, 4096)])
def test_fused_ln_mlp_int8_products_equal_int_mm(cuda, T, d, m, act_bf16):
    import ctypes
    from emr2a_tpu_torch.ops import _build
    x, s, b, w1q, w1s, b1, w2q, w2s, b2 = _mlp8_args(
        torch.Generator(device="cuda").manual_seed(T + act_bf16), T, d, m)
    x[0] = 0.0                                          # an all-zero row
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = _build.kernel_function("emr2a_fused_ln_mlp_int8", [p] * 15 + [i, i, i, i, ctypes.c_float, p])
    hq = torch.empty(T, d, device=cuda, dtype=torch.int8)
    hs, s2 = torch.empty(T, device=cuda), torch.empty(T, device=cuda)
    h1 = torch.empty(T, m, device=cuda)
    q2 = torch.empty(T, m, device=cuda, dtype=torch.int8)
    out = torch.empty_like(x)
    _build.check(fn(*(t.data_ptr() for t in (x, s, b, w1q, w1s, b1, w2q, w2s, b2,
                                              hq, hs, h1, q2, s2, out)),
                    T, d, m, act_bf16, 1e-6, torch.cuda.current_stream().cuda_stream),
                 "fused_ln_mlp_int8")
    torch.cuda.synchronize()
    # the LN's codes and scales: the plain version's, bit for bit
    q1_want, s1_want = quant.quantize_rows_s8_reference(mlp.layer_norm_exact_stats(x, s, b, 1e-6))
    assert torch.equal(hq, q1_want) and torch.equal(hs, s1_want.reshape(-1))
    # fc1: the f32 rescale of its exact sums, through the gelu into h1; the
    # bf16 gelu bit for bit, the f32 one within a few ulp (tanhf and the
    # cubic may round otherwise than PyTorch's ops, and 1 + tanh cancels in
    # gelu's negative tail, hence the absolute term)
    pre = _int_mm(hq, w1q).float() * hs.reshape(-1, 1)
    pre = pre * w1s.reshape(1, -1)
    pre = pre + b1.float()
    quick = act_bf16 & 2
    act, act_bf16 = ("quick_gelu" if quick else "gelu"), act_bf16 & 1
    exact = mlp.quick_gelu_bf16 if quick else mlp.gelu_tanh_bf16
    if act_bf16:
        assert torch.equal(h1, exact(pre)), (h1 - exact(pre)).abs().max()
    else:
        f32 = mlp._kernel_activation(act)
        torch.testing.assert_close(h1, f32(pre), rtol=2 ** -20, atol=2 ** -20)
    # h1's codes are the row quantize's of the h1 scratch
    q2_want, s2_want = quant.quantize_rows_s8_reference(h1)
    assert torch.equal(q2, q2_want) and torch.equal(s2, s2_want.reshape(-1))
    want = (x.float() + _rescale(_int_mm(q2, w2q), s2, w2s, b2).float()).to(torch.bfloat16)
    assert torch.equal(out, want), (out.float() - want.float()).abs().max()
    if act_bf16:                                        # so the whole block is the plain one's
        assert torch.equal(out, mlp.fused_ln_mlp_int8_reference(
            x, s, b, w1q, w1s, b1, w2q, w2s, b2, activation=act, act_dtype=torch.bfloat16))


@pytest.mark.parametrize("B,S,d,H,valid_len", [
    (1, 17, 128, 2, 13), (3, 50, 768, 12, 50), (32, 200, 768, 12, 197),
    (1, 384, 256, 4, 300), (2, 8, 768, 12, 1), (1, 385, 256, 4, 300),
    (2, 577, 768, 12, 570), (2, 260, 256, 4, 257), (8, 584, 1024, 16, 577),
])
def test_fused_ln_attention_int8_products_equal_int_mm_bit_for_bit(cuda, B, S, d, H,
                                                                   valid_len):
    import ctypes
    from emr2a_tpu_torch.ops import _build
    args = _attn8_args(torch.Generator(device="cuda").manual_seed(S + 1), B, S, d)
    x, s, b, ws = args[0], args[1], args[2], args[3:]
    x[:, S - 1] = 0.0
    T = B * S
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = _build.kernel_function("emr2a_fused_ln_attention_int8", [p] * 22 + [i] * 5 + [ctypes.c_float, p])
    hq, aq = (torch.empty(T, d, device=cuda, dtype=torch.int8) for _ in range(2))
    hs, as_ = torch.empty(T, device=cuda), torch.empty(T, device=cuda)
    qkv = torch.empty(3, T, d, device=cuda, dtype=torch.bfloat16)
    attn = torch.empty(T, d, device=cuda)
    out = torch.empty_like(x)
    _build.check(fn(*(t.data_ptr() for t in (x, s, b, *ws, hq, hs, qkv, attn, aq, as_, out)),
                    B, S, d, H, valid_len, 1e-6, torch.cuda.current_stream().cuda_stream),
                 "fused_ln_attention_int8")
    torch.cuda.synchronize()
    h_want = mlp.layer_norm_exact_stats(x.reshape(T, d), s, b, 1e-6)
    q_want, s_want = quant.quantize_rows_s8_reference(h_want)
    assert torch.equal(hq, q_want) and torch.equal(hs, s_want.reshape(-1))
    for z in range(3):
        wq, wsc, bias = ws[3 * z:3 * z + 3]
        want = _rescale(_int_mm(hq, wq), hs, wsc, bias)
        assert torch.equal(qkv[z], want), (z, (qkv[z].float() - want.float()).abs().max())
    want_q, want_s = quant.quantize_rows_s8_reference(attn)
    assert torch.equal(aq, want_q) and torch.equal(as_, want_s.reshape(-1))
    wq, wsc, bias = ws[9:12]
    want = (x.reshape(T, d).float() + _rescale(_int_mm(aq, wq), as_, wsc, bias).float()
            ).to(torch.bfloat16)
    assert torch.equal(out.reshape(T, d), want)


def test_int8_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = _rn(gen, 64, 768)
    wq, ws = _w8(gen, 768, 768)
    before = linear_int8.LAUNCHES
    with pytest.raises(TypeError, match="bfloat16"):
        linear_int8.linear_w8a8(x.float(), wq, ws)
    with pytest.raises(TypeError, match="int8"):
        linear_int8.linear_w8a8(x, wq.to(torch.bfloat16), ws)
    with pytest.raises(TypeError, match="out_dtype"):
        linear_int8.linear_w8a8(x, wq, ws, out_dtype=torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        linear_int8.linear_w8a8(_rn(gen, 768, 64).t(), wq, ws)
    w192, s192 = _w8(gen, 768, 192)
    with pytest.raises(ValueError, match="divisible by 128"):
        linear_int8.linear_w8a8(x, w192, s192)
    w48, s48 = _w8(gen, 48, 128)
    with pytest.raises(ValueError, match="divisible by 32"):
        linear_int8.linear_w8a8(_rn(gen, 4, 48), w48, s48)
    with pytest.raises(ValueError, match="shape"):
        linear_int8.linear_w8a8(x, wq, ws, _rn(gen, 128))
    with pytest.raises(ValueError, match="aligned"):
        linear_int8.linear_w8a8(_rn(gen, 2 * 768 + 1)[1:].reshape(2, 768), wq, ws)
    with pytest.raises(ValueError, match="device"):
        linear_int8.linear_w8a8(x.cpu().to("meta"), wq, ws)
    assert linear_int8.LAUNCHES == before
    margs = list(_mlp8_args(gen, 16, 768, 3072))
    with pytest.raises(TypeError, match="float32"):
        mlp.fused_ln_mlp_int8(*margs[:4], margs[4].to(torch.bfloat16), *margs[5:])
    with pytest.raises(ValueError, match="only, got 'relu'"):
        mlp.fused_ln_mlp_int8(*margs, activation="relu")
    x, s, b, *ws4 = _attn8_args(gen, 2, 16, 768)
    with pytest.raises(ValueError, match="contiguous"):
        attention_block.fused_ln_attention_int8(
            x.transpose(0, 1), s, b, *ws4, num_heads=12)


# -- K6: the fused cosine top-k ---------------------------------------------

def _topk_inputs(gen, q, n, dim, dtype):
    """Unit rows: f32/bf16 storage, or the DB's int8 codes and row scales."""
    db = torch.nn.functional.normalize(
        torch.randn(n, dim, generator=gen, device="cuda"), dim=-1)
    queries = torch.nn.functional.normalize(
        torch.randn(q, dim, generator=gen, device="cuda"), dim=-1)
    if dtype == "int8":
        scales = db.abs().amax(dim=1) / 127.0
        codes = torch.clamp(torch.round(db / scales[:, None]), -127, 127)
        return queries, (codes.to(torch.int8), scales)
    return queries, (db.to(dtype),)


def _run_topk(dtype, queries, db, k, n_valid):
    if dtype == "int8":
        return (topk.cosine_topk_fused_int8(queries, *db, k, n_valid),
                topk.cosine_topk_fused_int8_reference(queries, *db, k, n_valid))
    return (topk.cosine_topk_fused(queries, db[0], k, n_valid),
            topk.cosine_topk_fused_reference(queries, db[0], k, n_valid))


def assert_topk_agrees(got, want, scores, tol=1e-5):
    """Values within tol; an index may differ from the plain version's only
    where the plain scores of the two rows lie within tol of each other."""
    (gv, gi), (wv, wi) = got, want
    assert gv.shape == wv.shape and gi.dtype == torch.int32
    torch.testing.assert_close(gv, wv, atol=tol, rtol=0)
    diff = gi != wi
    if diff.any():
        rows = diff.nonzero()[:, 0]
        picked = scores[rows, gi[diff].long()]
        assert (picked - wv[diff]).abs().max().item() <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, "int8"])
@pytest.mark.parametrize("q,n,dim,k,n_valid", [
    (1, 5000, 512, 5, None), (7, 1000, 40, 1, 777), (130, 3001, 96, 64, 2999),
    (64, 20000, 512, 10, None), (3, 64, 1024, 64, None),
])
def test_cosine_topk_fused_kernel_matches_plain(cuda, dtype, q, n, dim, k, n_valid):
    gen = torch.Generator(device="cuda").manual_seed(n + dim)
    queries, db = _topk_inputs(gen, q, n, dim, dtype)
    counter = "INT8_LAUNCHES" if dtype == "int8" else "LAUNCHES"
    before = getattr(topk, counter)
    got, want = _run_topk(dtype, queries, db, k, n_valid)
    torch.cuda.synchronize()
    assert getattr(topk, counter) == before + 1
    assert got[1].max().item() < (n_valid or n)
    if dtype == "int8":
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    else:
        scores = queries.to(dtype).float() @ db[0].float().T
        assert_topk_agrees(got, want, scores)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, "int8"])
def test_cosine_topk_fused_ties_go_to_the_lowest_index(cuda, dtype):
    gen = torch.Generator(device="cuda").manual_seed(3)
    queries, db = _topk_inputs(gen, 4, 3000, 96, dtype)
    dups = [5, 700, 701, 1999, 2998]       # four copies of row 5, in other chunks
    for t in db:
        t[dups[1:]] = t[dups[0]].clone()
    queries[:2] = (db[0][dups[0]].float() if dtype != "int8"
                   else db[0][dups[0]].float() * db[1][dups[0]])
    (gv, gi), _ = _run_topk(dtype, queries, db, 8, None)
    torch.cuda.synchronize()
    for row in range(2):
        assert gi[row, :5].tolist() == dups
        assert (gv[row, :5] == gv[row, 0]).all()


_CODE = {torch.float32: 0, torch.bfloat16: 1, "int8": 2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, "int8"])
@pytest.mark.parametrize("q,n,dim,k,n_valid", [
    (8, 5000, 64, 1, None), (16, 3001, 512, 5, 2999), (64, 20000, 1024, 64, 19000),
    (100, 4097, 512, 65, None), (64, 3000, 64, 1000, 2500), (100, 1500, 1024, 1000, None),
    (8, 777, 40, 5, 700), (16, 129, 512, 129, None),
])
def test_cosine_topk_tile_scan_matches_plain(cuda, monkeypatch, dtype, q, n, dim, k, n_valid):
    """K6's tile scan (tensor cores for bf16 and s8, FFMA for f32), forced
    at every q: ragged n, n_valid < n, k past the streaming scan's 64 up to
    1000 and up to n_valid."""
    monkeypatch.setitem(topk.TILE_MIN_Q, _CODE[dtype], 1)
    gen = torch.Generator(device="cuda").manual_seed(n + dim + k)
    queries, db = _topk_inputs(gen, q, n, dim, dtype)
    before = topk.TILE_LAUNCHES
    got, want = _run_topk(dtype, queries, db, k, n_valid)
    torch.cuda.synchronize()
    assert topk.TILE_LAUNCHES == before + 1
    assert got[1].shape == (q, k) and got[1].max().item() < (n_valid or n)
    if dtype == "int8":
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    else:
        scores = queries.to(dtype).float() @ db[0].float().T
        assert_topk_agrees(got, want, scores)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, "int8"])
@pytest.mark.parametrize("k", [5, 70])
def test_cosine_topk_tile_scan_ties_go_to_the_lowest_index(cuda, monkeypatch, dtype, k):
    """Equal rows in other tiles and chunks of the tile scan: the lowest
    index first, at a k inside and past the streaming scan's lists."""
    monkeypatch.setitem(topk.TILE_MIN_Q, _CODE[dtype], 1)
    gen = torch.Generator(device="cuda").manual_seed(5)
    queries, db = _topk_inputs(gen, 20, 40000, 512, dtype)
    dups = [5, 127, 128, 20001, 39998]      # one tile edge, other chunks
    for t in db:
        t[dups[1:]] = t[dups[0]].clone()
    queries[:3] = (db[0][dups[0]].float() if dtype != "int8"
                   else db[0][dups[0]].float() * db[1][dups[0]])
    (gv, gi), _ = _run_topk(dtype, queries, db, k, None)
    torch.cuda.synchronize()
    for row in range(3):
        assert gi[row, :5].tolist() == dups
        assert (gv[row, :5] == gv[row, 0]).all()


def test_cosine_topk_fused_refuses_what_the_kernel_does_not_take(cuda):
    gen = torch.Generator(device="cuda").manual_seed(4)
    queries, (db,) = _topk_inputs(gen, 2, 500, 96, torch.float32)
    before = topk.LAUNCHES
    with pytest.raises(ValueError, match="valid rows"):
        topk.cosine_topk_fused(queries, db, 501)
    with pytest.raises(ValueError, match="k must be"):
        topk.cosine_topk_fused(queries, db, 0)
    with pytest.raises(ValueError, match="valid rows"):
        topk.cosine_topk_fused(queries, db, 10, n_valid=9)
    with pytest.raises(ValueError, match="divisible by 8"):
        topk.cosine_topk_fused(queries[:, :90], db[:, :90].contiguous(), 5)
    with pytest.raises(ValueError, match="contiguous"):
        topk.cosine_topk_fused(queries, db.t().contiguous().t(), 5)
    with pytest.raises(TypeError, match="f32 or bf16"):
        topk.cosine_topk_fused(queries, db.half(), 5)
    assert topk.LAUNCHES == before


# -- K7: the W4A8 linear ----------------------------------------------------

def _w4(gen, K, N, std=0.02):
    """Packed int4 weights and group scales of bf16 weights, quantized on the
    card (the twin of the numpy recipe)."""
    return linear_int4.quantize_weight_int4_torch(_rn(gen, K, N, std=std).float())


@pytest.mark.parametrize("T,K,N", [(1, 4096, 4096), (1, 4096, 1024), (1, 4096, 12288),
                                   (1, 12288, 4096), (2, 256, 384), (1, 12288, 1024),
                                   (5, 4096, 12288), (15, 4096, 1024), (16, 12288, 4096),
                                   (16, 12288, 1024), (17, 4096, 1024), (31, 4096, 1024),
                                   (300, 256, 128), (1100, 4096, 1024), (2048, 4096, 4096),
                                   (2048, 12288, 4096)])
@pytest.mark.parametrize("use_bias", [True, False])
def test_linear_w4a8_kernel_equals_plain(cuda, T, K, N, use_bias):
    gen = torch.Generator(device="cuda").manual_seed(T + K + N)
    x = _rn(gen, T, K)
    if T > 2:
        x[1] = x[0]                      # duplicate rows give identical outputs
        x[2] = 0.0                       # an all-zero row
    wp, ws = _w4(gen, K, N)
    b = _rn(gen, N, std=0.02) if use_bias else None
    before = linear_int4.LAUNCHES
    got = linear_int4.linear_w4a8(x, wp, ws, b)
    torch.cuda.synchronize()
    assert linear_int4.LAUNCHES == before + 1
    want = linear_int4.linear_w4a8_reference(x, wp, ws, b)
    assert got.dtype == torch.bfloat16 and got.shape == (T, N)
    assert torch.equal(got, want), (got.float() - want.float()).abs().max()
    if T > 2:
        assert torch.equal(got[0], got[1])
    stream = torch.cuda.current_stream().cuda_stream
    assert not linear_int8.workspace(x.device, stream, 0, N // 128)[1].any()   # left at zero


@pytest.mark.parametrize("T", [1, 16, 17, 256])
def test_linear_w4a8_leading_axes_and_zero_rows(cuda, T):
    gen = torch.Generator(device="cuda").manual_seed(6)
    x = _rn(gen, 3, T, 1024)
    x[2, 0] = 0.0
    wp, ws = _w4(gen, 1024, 512)
    b = _rn(gen, 512, std=0.02)
    got = linear_int4.linear_w4a8(x, wp, ws, b)
    torch.cuda.synchronize()
    assert got.shape == (3, T, 512)
    assert torch.equal(got, linear_int4.linear_w4a8_reference(x, wp, ws, b))
    assert torch.equal(got[2, 0], b)


def test_quantize_weight_int4_torch_equals_numpy(cuda):
    gen = torch.Generator(device="cuda").manual_seed(11)
    w = _rn(gen, 4096, 1536, std=0.02).float()
    w[:128, 7] = 0.0                     # a zero group
    w[128:256, 9] = 3.5 * torch.tensor([1.0, -1.0], device="cuda").repeat(64)  # ties
    wp, ws = linear_int4.quantize_weight_int4_torch(w)
    np_p, np_s = linear_int4.quantize_weight_int4(w.cpu().numpy())
    assert torch.equal(wp.cpu(), torch.from_numpy(np_p))
    assert torch.equal(ws.cpu(), torch.from_numpy(np_s))


def test_linear_w4a8_refuses_what_the_kernel_does_not_take(cuda):
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = _rn(gen, 4, 512)
    wp, ws = _w4(gen, 512, 256)
    before = linear_int4.LAUNCHES
    with pytest.raises(TypeError, match="bfloat16"):
        linear_int4.linear_w4a8(x.float(), wp, ws)
    with pytest.raises(TypeError, match="out_dtype"):
        linear_int4.linear_w4a8(x, wp, ws, out_dtype=torch.float32)
    w64 = linear_int4.quantize_weight_int4_torch(_rn(gen, 512, 256).float(), group=64)
    with pytest.raises(ValueError, match="group 128"):
        linear_int4.linear_w4a8(x, *w64)
    w192 = _w4(gen, 512, 192)
    with pytest.raises(ValueError, match="divisible by 128"):
        linear_int4.linear_w4a8(x, *w192)
    with pytest.raises(ValueError, match="contiguous"):
        linear_int4.linear_w4a8(_rn(gen, 512, 4).t(), wp, ws)
    with pytest.raises(ValueError, match="shape"):
        linear_int4.linear_w4a8(x, wp, ws[:, :128])
    with pytest.raises(ValueError, match="shape"):
        linear_int4.linear_w4a8(x, wp, ws, _rn(gen, 128))
    with pytest.raises(ValueError, match="aligned"):
        linear_int4.linear_w4a8(_rn(gen, 4 * 512 + 1)[1:].reshape(4, 512), wp, ws)
    with pytest.raises(ValueError, match="device"):
        linear_int4.linear_w4a8(x.cpu().to("meta"), wp, ws)
    assert linear_int4.LAUNCHES == before


# -- K8 and K9: the per-frame attention kernel ------------------------------

def _assert_attention_close(got, want):
    """bf16 outputs; the kernel rounds unnormalised probabilities to bf16
    where the plain version rounds normalised ones: atol = rtol = 1e-2 and
    row cosine >= 0.9999, as for K1 to K4."""
    assert torch.isfinite(got.float()).all()
    _assert_matches(got, want)


@pytest.mark.parametrize("F,S,H,hd", [(7, 1024, 16, 72), (2, 197, 4, 72), (1, 1, 2, 64),
                                      (3, 65, 2, 128), (2, 130, 3, 8), (1, 256, 16, 72),
                                      (1, 1000, 16, 72), (2, 1024, 4, 128), (1, 129, 3, 40)])
def test_frame_flash_attention_kernel_matches_plain(cuda, F, S, H, hd):
    gen = torch.Generator(device="cuda").manual_seed(S + hd)
    q, k, v = (_rn(gen, F, S, H, hd) for _ in range(3))
    k[0, S // 2] = k[0, 0]               # duplicate keys
    scale = hd ** -0.5
    before = vision_flash.LAUNCHES
    got = vision_flash.frame_flash_attention(q, k, v, scale)
    torch.cuda.synchronize()
    assert vision_flash.LAUNCHES == before + 1
    _assert_attention_close(got, vision_flash.frame_flash_attention_reference(q, k, v, scale))


@pytest.mark.parametrize("B,S,H,D", [(32, 197, 12, 64), (2, 100, 2, 32), (3, 50, 1, 16),
                                     (1, 128, 2, 72), (4, 197, 12, 128), (2, 257, 2, 64)])
def test_fused_attention_kernel_matches_plain(cuda, B, S, H, D):
    gen = torch.Generator(device="cuda").manual_seed(B * S)
    q, k, v = (_rn(gen, B, S, H, D) for _ in range(3))
    k = (k.float() + 5.0).to(torch.bfloat16)     # large keys: no mass may leak
    before = attention.LAUNCHES
    got = attention.fused_attention(q, k, v)
    torch.cuda.synchronize()
    assert attention.LAUNCHES == before + 1
    _assert_attention_close(got, attention.fused_attention_reference(q, k, v))


def test_attention_kernel_refuses_what_it_does_not_take(cuda):
    gen = torch.Generator(device="cuda").manual_seed(9)
    q = _rn(gen, 2, 16, 2, 72)
    before = vision_flash.LAUNCHES
    with pytest.raises(TypeError, match="bfloat16"):
        vision_flash.frame_flash_attention(q.float(), q.float(), q.float(), 0.1)
    with pytest.raises(ValueError, match="divisible by 8"):
        vision_flash.frame_flash_attention(q[..., :68].contiguous(),
                                           q[..., :68].contiguous(),
                                           q[..., :68].contiguous(), 0.1)
    big = _rn(gen, 1, 8, 1, 136)
    with pytest.raises(ValueError, match="at most 128"):
        attention.fused_attention(big, big, big)
    with pytest.raises(ValueError, match="contiguous"):
        vision_flash.frame_flash_attention(q.transpose(1, 2), q.transpose(1, 2),
                                           q.transpose(1, 2), 0.1)
    assert vision_flash.LAUNCHES == before
