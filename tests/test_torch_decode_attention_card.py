"""K10 (``ops/decode_attention.py``, ``csrc/decode_attention.cu``) on the
card, against its plain version:

- at the judge cells' shapes (the 8B's 32 query and 8 kv heads of 128 over
  a cache of 2,240 positions: 8 slots at S = 1, B = 1 at S = 1, a
  speculative verify at S = 5), on one card of tp = 2 (4 kv heads), at
  S = 16 (64 rows a kv head), a cache of one split (L <= 64) and a ragged
  last tile, a cache read through its strides (a slice of a larger
  buffer), an expanded mask, and the no-cache case (L = S);
- two calls, and a call replayed from a CUDA graph, bit-identical;
- a mask that leaves whole splits (and a warp's share of a tile) with no
  visible position: finite output, still the plain version's;
- ``LAUNCHES`` equal to the layers times the decoder's S <= 16 forwards
  (eager steps, and a generation whose steps replay a CUDA graph), and
  nothing for the int8 KV cache.

Tolerance: atol = rtol = 1e-2 and row cosine >= 0.9999, as K8's: the kernel
rounds the unnormalised probabilities to bf16 and sums in another order
where the plain version rounds the normalised ones, so the two agree to
bf16's precision, not bit for bit.

Each test skips without a CUDA card. On the card (the suite's conftest
imports JAX, which that machine lacks):

    python -m pytest --noconftest tests/test_torch_decode_attention_card.py -q
"""

import numpy as np
import pytest
import torch

from emr2a_tpu_torch.models import cuda_graph
from emr2a_tpu_torch.models import qwen3_vl as pq
from emr2a_tpu_torch.ops import decode_attention as da


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card with sm_90a (H100)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def operands(B, S, H, KV, L, seed=0, q_std=2.0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    rn = lambda *shape, std=1.0: (torch.randn(*shape, generator=g, device="cuda")
                                  * std).to(torch.bfloat16)
    return rn(B, S, H, 128, std=q_std), rn(B, L, KV, 128), rn(B, L, KV, 128)


def visible_mask(B, S, L, seed=0):
    """Each row sees a random prefix (its prompt) and a causal run of
    positions after it (its generated tokens, one more each query row)."""
    rng = np.random.RandomState(seed)
    tl = torch.as_tensor(rng.randint(1, L // 2, B), device="cuda")
    off = torch.as_tensor(rng.randint(0, L // 2 - S, B), device="cuda")
    k_idx = torch.arange(L, device="cuda")[None, None, :]
    q_abs = L // 2 + off[:, None, None] + torch.arange(S, device="cuda")[None, :, None]
    visible = (k_idx < tl[:, None, None]) | ((k_idx >= L // 2) & (k_idx <= q_abs))
    return torch.where(visible, 0.0, float("-inf")).float()


def assert_matches(got, want):
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    got = got.float().reshape(-1, 128)
    want = want.float().reshape(-1, 128)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=1e-2, rtol=1e-2)
    cos = torch.nn.functional.cosine_similarity(got, want, dim=-1)
    assert cos.min().item() >= 0.9999


SHAPES = {  # B, S, H, KV, L
    "audit_8_slots": (8, 1, 32, 8, 2240),
    "audit_solo": (1, 1, 32, 8, 2240),
    "verify_b1": (1, 5, 32, 8, 2240),
    "verify_8_slots": (8, 5, 32, 8, 2240),
    "tp2_card": (1, 1, 16, 4, 2112),
    "s16": (2, 16, 32, 8, 1000),
    "one_split": (3, 2, 32, 8, 64),
    "ragged_tile": (2, 3, 32, 8, 451),
    "groups_2": (2, 7, 2, 1, 300),
}


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_kernel_matches_plain(cuda, shape):
    B, S, H, KV, L = SHAPES[shape]
    q, k, v = operands(B, S, H, KV, L, seed=len(shape))
    m = visible_mask(B, S, L, seed=B + S)
    before = da.LAUNCHES
    got = da.decode_attention(q, k, v, m, 128 ** -0.5)
    torch.cuda.synchronize()
    assert da.LAUNCHES == before + 1
    assert_matches(got, da.decode_attention_reference(q, k, v, m, 128 ** -0.5))


def test_strided_cache_and_expanded_mask(cuda):
    B, S, H, KV, L = 2, 1, 32, 8, 700
    big_k = operands(B, S, H, 2 * KV, L + 50, seed=5)[1]
    q, _, v = operands(B, S, H, KV, L, seed=6)
    k = big_k[:, 10:10 + L, KV:]                   # positions and heads of a larger buffer
    m = visible_mask(1, S, L, seed=2).expand(B, S, L)
    got = da.decode_attention(q, k, v, m, 128 ** -0.5)
    assert_matches(got, da.decode_attention_reference(q, k, v, m, 128 ** -0.5))


def test_no_cache(cuda):
    """A prefill of S <= 16 with no cache: the fresh K and V (L = S) under
    the causal mask."""
    B, S, H, KV = 2, 9, 32, 8
    q, k, v = operands(B, S, H, KV, S, seed=8)
    i = torch.arange(S, device="cuda")
    m = torch.where(i[None, :] <= i[:, None], 0.0, float("-inf")).float()[None].expand(B, S, S)
    assert_matches(da.decode_attention(q, k, v, m, 128 ** -0.5),
                   da.decode_attention_reference(q, k, v, m, 128 ** -0.5))


def test_deterministic_and_graph_replay(cuda):
    B, S, H, KV, L = SHAPES["audit_8_slots"]
    q, k, v = operands(B, S, H, KV, L, seed=9)
    m = visible_mask(B, S, L, seed=9)
    a = da.decode_attention(q, k, v, m, 128 ** -0.5)
    b = da.decode_attention(q, k, v, m, 128 ** -0.5)
    assert torch.equal(a, b)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        da.decode_attention(q, k, v, m, 128 ** -0.5)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = da.decode_attention(q, k, v, m, 128 ** -0.5)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, a)


@pytest.mark.parametrize("B", [1, 8])
def test_masked_splits(cuda, B):
    """Only the first 100 positions of 2,240 visible: every later split,
    and the warps' shares past 100 in the first tiles, see nothing."""
    S, H, KV, L = 1, 32, 8, 2240
    q, k, v = operands(B, S, H, KV, L, seed=11)
    m = torch.full((B, S, L), float("-inf"), device="cuda")
    m[:, :, :100] = 0.0
    m[0, :, 37] = float("-inf")
    got = da.decode_attention(q, k, v, m, 128 ** -0.5)
    assert_matches(got, da.decode_attention_reference(q, k, v, m, 128 ** -0.5))


def small_config():
    return pq.Qwen3VLConfig(
        vision=pq.QwenVisionConfig(depth=1, hidden_size=64, intermediate_size=128,
                                   num_heads=2, patch_size=4, out_hidden_size=256,
                                   num_position_embeddings=64,
                                   deepstack_visual_indexes=(0,), dtype=torch.bfloat16),
        text=pq.QwenTextConfig(vocab_size=1024, hidden_size=512, num_layers=3, num_heads=4,
                               num_kv_heads=1, head_dim=128, intermediate_size=512,
                               mrope_section=(24, 20, 20), tie_word_embeddings=False,
                               dtype=torch.bfloat16))


IDS = np.array([[3, 5, 8, 13, 21, 34, 55, 89, 144, 6, 7, 9, 10, 11, 12, 14, 15, 16, 17,
                 18]], np.int64)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_launches_count_decode_forwards(cuda, kv_dtype):
    """Eager decode steps, then a generation whose steps replay a CUDA
    graph: the layers times the decoder forwards at S <= 16 (the prefill of
    a 32-token bucket is not one), and none with the int8 cache."""
    cfg = small_config()
    model = pq.Qwen3VLModel.from_params(cfg, pq.random_state(cfg, seed=0, device="cuda"))
    gen = pq.Qwen3VLGenerator(model, eos_token_id=-1, kv_dtype=kv_dtype)
    layers = cfg.text.num_layers
    per = layers if kv_dtype == "bf16" else 0
    with torch.inference_mode():
        state = gen.start(np.repeat(IDS, 2, axis=0), steps=6, prompt_bucket=32)
        before = da.LAUNCHES
        for _ in range(6):
            gen.decode_step(state)
        assert da.LAUNCHES - before == 6 * per
        replayed = cuda_graph.replayed_forwards(model.language_model)
        before = da.LAUNCHES
        gen.generate(IDS, max_new_tokens=7, prompt_bucket=32)
        torch.cuda.synchronize()
        assert cuda_graph.replayed_forwards(model.language_model) - replayed == 6
        # one eager warm-up step and six replays; the prefill (S = 32) is not counted
        assert da.LAUNCHES - before == 7 * per
