"""The operations and bytes behind the rooflines and mfu metrics, against
counts made by hand."""

import pytest

from benchmark.core import registry


def _cfg(name):
    return registry.config(registry.load_benchmark(), name)


def test_vit_b16_flops_per_slice():
    # patch embedding 2 x 196 x 768 x 768 = 0.2312 GFLOP; each of 12 blocks
    # 8 x 197 x 768^2 + 4 x 197^2 x 768 + 4 x 197 x 768 x 3072 = 2.9080 GFLOP;
    # head 2 x 768 x 512
    got = registry.metric("tower_mfu.embed").flops_per_slice(_cfg("biomedclip"))
    assert got == pytest.approx(35.127e9, rel=1e-4)


def test_k1_bound():
    # 4 x 25,216 x 768 x 3,072 operations at 989 TFLOP/s
    assert registry.metric("k1_roofline.embed").least(25216, 768, 3072) * 1e3 == \
        pytest.approx(0.2406, abs=1e-4)


def test_k1_counts_useful_rows():
    k1 = registry.metric("k1_roofline.embed")
    assert k1.useful_rows(128 * 200, _cfg("biomedclip")) == 128 * 197


def test_k3_bound():
    # 8 x 25,216 x 768^2 + 4 x 128 x 197^2 x 768 operations
    assert registry.metric("k3_roofline.embed").least(128, 197, 768) * 1e3 == \
        pytest.approx(0.1357, abs=1e-4)


def test_k8_bound():
    # 4 x 7 x 1,024^2 x 16 x 72 operations
    assert registry.metric("k8_roofline.audit").least(7, 1024, 16, 72) * 1e3 == \
        pytest.approx(0.0342, abs=1e-4)


def test_k8_small_call_is_bound_by_bytes():
    from benchmark.core.peaks import HBM_BYTES
    got = registry.metric("k8_roofline.audit").least(1, 8, 1, 64)
    assert got == pytest.approx(2 * 4 * 8 * 64 / HBM_BYTES)


def test_judge_request_flops():
    m = registry.metric("judge_mfu.audit")
    cfg = _cfg("qwen3-vl-8b")
    # one 512 x 512 image: 1,024 patches, 27 blocks of 8 N D^2 + 4 N^2 D +
    # 4 N D I, the patch embedding and four mergers over 256 tokens
    D, I, N = 1152, 4304, 1024
    by_hand = (2 * N * 1536 * D + 27 * (8 * N * D * D + 4 * N * N * D + 4 * N * D * I)
               + 4 * 256 * (2 * 4608 * 4608 + 2 * 4608 * 4096))
    assert m.image_flops(cfg, (1, 32, 32)) == by_hand
    # the decoder's linear work for one token: 36 x 2 x 192.9 M
    per_token = 36 * 2 * (4096 * (4096 + 2048) + 4096 * 4096 + 3 * 4096 * 12288)
    assert m._token_flops(cfg, 0, 1) == per_token + 36 * 4 * 4096
    req = {"prompt_len": 2034, "served": list(range(96)), "grids": [(1, 32, 32)] * 7}
    assert m.request_flops(cfg, req, 0) == pytest.approx(38.44e12, rel=1e-3)
    # a shared prefix moves its tokens out of each request
    assert m.request_flops(cfg, req, 100) + m.prefix_flops(cfg, 100) == \
        pytest.approx(m.request_flops(cfg, req, 0), rel=1e-12)
