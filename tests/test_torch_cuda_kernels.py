"""The kernels on the card, at shapes beyond the main path's: K1 and K3
(bf16) and K2, K4, K5 (W8A8) at ragged token counts including T = 1 and
T < 32, short and maximal sequences, valid_len edges, all-zero rows, the
row quantize's codes; K6 (the fused cosine top-k, f32, bf16 and int8) at
ragged row counts, n_valid < n, k = 1 and k = K_MAX, several query counts
and widths, and duplicated rows; the inputs the wrappers must refuse, and
the launch counters. Each test skips without a CUDA card. On the card (the suite's
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
the plain version scores the two rows within 1e-5 of each other.
"""

import pytest
import torch

from emr2a_tpu_torch.ops import attention_block, linear_int8, mlp, quant, topk


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


@pytest.mark.parametrize("T,K,N", [(1, 768, 768), (7, 768, 3072), (31, 3072, 768),
                                   (300, 768, 3072), (8192, 3072, 3072)])
@pytest.mark.parametrize("use_bias", [True, False])
def test_linear_w8a8_kernel_equals_plain(cuda, T, K, N, use_bias):
    gen = torch.Generator(device="cuda").manual_seed(T + K)
    x = _rn(gen, T, K)
    wq, ws = _w8(gen, K, N)
    b = _rn(gen, N, std=0.02) if use_bias else None
    before = linear_int8.LAUNCHES
    got = linear_int8.linear_w8a8(x, wq, ws, b)
    torch.cuda.synchronize()
    assert linear_int8.LAUNCHES == before + 1
    want = linear_int8.linear_w8a8_reference(x, wq, ws, b)
    assert got.dtype == torch.bfloat16 and got.shape == (T, N)
    assert torch.equal(got, want), (got.float() - want.float()).abs().max()


def test_linear_w8a8_leading_axes_and_zero_rows(cuda):
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = _rn(gen, 4, 256, 768)
    x[1, 3] = 0.0
    wq, ws = _w8(gen, 768, 768)
    b = _rn(gen, 768, std=0.02)
    got = linear_int8.linear_w8a8(x, wq, ws, b)
    torch.cuda.synchronize()
    assert got.shape == (4, 256, 768)
    assert torch.equal(got, linear_int8.linear_w8a8_reference(x, wq, ws, b))
    assert torch.equal(got[1, 3], b)


def _mlp8_args(gen, T, d, m):
    x, s, b = _rn(gen, T, d), (1 + _rn(gen, d, std=0.1).float()).to(torch.bfloat16), \
        _rn(gen, d, std=0.1)
    w1q, w1s = _w8(gen, d, m)
    w2q, w2s = _w8(gen, m, d)
    return x, s, b, w1q, w1s, _rn(gen, m, std=0.02), w2q, w2s, _rn(gen, d, std=0.02)


@pytest.mark.parametrize("T,d,m", [(1, 768, 3072), (7, 768, 3072), (300, 768, 3072),
                                   (6437, 768, 3072), (129, 256, 512)])
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
    (1, 384, 256, 4, 300), (2, 8, 768, 12, 1),
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
    assert linear_int8.LAUNCHES == before
    margs = list(_mlp8_args(gen, 16, 768, 3072))
    with pytest.raises(TypeError, match="float32"):
        mlp.fused_ln_mlp_int8(*margs[:4], margs[4].to(torch.bfloat16), *margs[5:])
    with pytest.raises(ValueError, match="gelu only"):
        mlp.fused_ln_mlp_int8(*margs, activation="quick_gelu")
    x, s, b, *ws4 = _attn8_args(gen, 1, 385, 256)
    with pytest.raises(ValueError, match="up to 384"):
        attention_block.fused_ln_attention_int8(x, s, b, *ws4, num_heads=4)
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


def test_cosine_topk_fused_refuses_what_the_kernel_does_not_take(cuda):
    gen = torch.Generator(device="cuda").manual_seed(4)
    queries, (db,) = _topk_inputs(gen, 2, 500, 96, torch.float32)
    before = topk.LAUNCHES
    with pytest.raises(ValueError, match="k must be"):
        topk.cosine_topk_fused(queries, db, topk.K_MAX + 1)
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
