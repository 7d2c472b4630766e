"""K10's plain version and routing on the CPU (``ops/decode_attention.py``,
the S <= 16 branch of ``QwenTextDecoderLayer.attention_context``).

- ``decode_attention_reference`` equals the branch's former inline einsums
  (kept here as ``inline_branch``) bit for bit, at B in {1, 8}, S in {1, 5,
  16}, KV in {8, 4} (the 8B's kv heads on one card and on each of two), 4
  query heads a kv head, under a ring mask (the continuous batcher's) and a
  per-row-offset mask with causal query rows (a speculative verify's), and
  with an int8 cache's scales.
- Routing: a CPU tensor takes the plain version through the wrapper; a
  bf16 cache at S <= 16 reaches the wrapper, an int8 cache (the 4-tuple) and
  an f32 cache take the plain version directly, and S > 16 never reaches
  either.
- The wrapper refuses (on meta tensors, which reach its checks without a
  card) a wrong dtype, head width, S > 16 or too many rows; the split size
  comes from the shape alone.
- The tiny judge's greedy streams through ``generate`` and
  ``generate_stream`` in bf16 are those of the former branch.

The kernel itself runs only on the card: ``tests/test_torch_decode_attention_card.py``.
"""

import numpy as np
import pytest
import torch
from PIL import Image

from emr2a_tpu_torch.models import qwen3_vl as pq
from emr2a_tpu_torch.ops import decode_attention as da

torch.set_num_threads(1)


def inline_branch(q, k_all, v_all, attn_mask, kq_scale=None, vq_scale=None,
                  dtype=torch.bfloat16):
    """The S <= 16 branch of ``attention_context`` as it was inline."""
    B, S, H, hd = q.shape
    KV = k_all.shape[2]
    groups = H // KV
    scale = hd ** -0.5
    q_g = q.reshape(B, S, KV, groups, hd)
    logits = torch.einsum("bqkgd,blkd->bkgql", q_g.float(),
                          k_all.float()) * scale
    if kq_scale is not None:
        logits = logits * kq_scale.transpose(1, 2)[:, :, None, None, :]
    logits = logits + attn_mask[:, None, None, :, :]
    probs = torch.softmax(logits, dim=-1)
    if vq_scale is not None:
        probs = probs * vq_scale.transpose(1, 2)[:, :, None, None, :]
    probs = probs.to(dtype)
    attn = torch.einsum("bkgql,blkd->bqkgd", probs.float(),
                        v_all.float()).to(dtype)
    return attn.reshape(B, S, H * hd)


def ring_mask(B, S, L, P, seed):
    """The batcher's ring layout: row b sees its prompt (< true length) and
    the ring slots whose token age is within its generated count, each
    query row one step further."""
    rng = np.random.RandomState(seed)
    tl = torch.as_tensor(rng.randint(P // 2, P + 1, B))
    gen = torch.as_tensor(rng.randint(0, L - P - S, B))
    step = int(rng.randint(0, 4 * (L - P)))
    k_idx = torch.arange(L)[None, None, :]
    i = torch.arange(S)[None, :, None]
    age = torch.remainder(step + i - (k_idx - P), L - P)
    visible = (k_idx < tl[:, None, None]) | ((k_idx >= P) & (age <= gen[:, None, None] + i))
    return torch.where(visible, 0.0, float("-inf")).float()


def offset_mask(B, S, L, P, seed):
    """Per-row cache offsets with causal query rows: row b's query i sees
    its prompt and the positions up to P + offset_b + i."""
    rng = np.random.RandomState(seed)
    tl = torch.as_tensor(rng.randint(1, P + 1, B))
    off = torch.as_tensor(rng.randint(0, L - P - S + 1, B))
    k_idx = torch.arange(L)[None, None, :]
    q_abs = P + off[:, None, None] + torch.arange(S)[None, :, None]
    visible = (k_idx < tl[:, None, None]) | ((k_idx >= P) & (k_idx <= q_abs))
    return torch.where(visible, 0.0, float("-inf")).float()


MASKS = {"ring": ring_mask, "offsets": offset_mask}


def operands(B, S, KV, L=96, G=4, hd=128, seed=0, dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, S, KV * G, hd, generator=g).to(dtype)
    k = torch.randn(B, L, KV, hd, generator=g).to(dtype)
    v = torch.randn(B, L, KV, hd, generator=g).to(dtype)
    return q, k, v


@pytest.mark.parametrize("mask", sorted(MASKS))
@pytest.mark.parametrize("KV", [8, 4])
@pytest.mark.parametrize("S", [1, 5, 16])
@pytest.mark.parametrize("B", [1, 8])
def test_reference_is_the_inline_branch(B, S, KV, mask):
    L = 96
    q, k, v = operands(B, S, KV, L, seed=B * 100 + S * 10 + KV)
    m = MASKS[mask](B, S, L, 48, seed=S)
    got = da.decode_attention_reference(q, k, v, m, 128 ** -0.5)
    assert got.dtype == torch.bfloat16 and got.shape == (B, S, KV * 4 * 128)
    assert torch.equal(got, inline_branch(q, k, v, m))
    # through the wrapper: a CPU tensor takes the plain version, no launch
    before = da.LAUNCHES
    assert torch.equal(da.decode_attention(q, k, v, m, 128 ** -0.5), got)
    assert da.LAUNCHES == before


@pytest.mark.parametrize("S", [1, 5])
def test_reference_with_int8_scales_is_the_inline_branch(S):
    B, KV, L = 2, 4, 80
    q, k, v = operands(B, S, KV, L, seed=S)
    kq, ks = pq.quantize_kv(k)
    vq, vs = pq.quantize_kv(v)
    m = offset_mask(B, S, L, 40, seed=3)
    got = da.decode_attention_reference(q, kq, vq, m, 128 ** -0.5, ks, vs)
    assert torch.equal(got, inline_branch(q, kq, vq, m, ks, vs))


# -- routing in the decoder layer ---------------------------------------------

def tiny_layer(dtype):
    cfg = pq.QwenTextConfig(hidden_size=64, num_layers=1, num_heads=4, num_kv_heads=2,
                            head_dim=16, intermediate_size=96, mrope_section=(4, 2, 2),
                            dtype=dtype)
    torch.manual_seed(0)
    layer = pq.QwenTextDecoderLayer(cfg)
    with torch.no_grad():
        for p in layer.parameters():
            p.copy_(torch.randn(p.shape) * 0.05 + (1 if p.dim() == 1 else 0))
    return cfg, layer


def layer_inputs(cfg, S, L, kv_dtype):
    torch.manual_seed(1)
    B = 2
    x = torch.randn(B, S, cfg.hidden_size).to(cfg.dtype)
    cos = torch.ones(B, S, cfg.head_dim)
    sin = torch.zeros(B, S, cfg.head_dim)
    cache = pq.empty_kv_cache(cfg, B, L, kv_dtype)[0]
    mask = offset_mask(B, S, L, L // 2, seed=2) if S <= L // 2 else \
        torch.where(torch.arange(L)[None, None] <= torch.arange(S)[None, :, None], 0.0,
                    float("-inf")).float().expand(B, S, L)
    return x, cos, sin, cache, mask


class Spy:
    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __call__(self, *args, **kw):
        self.calls.append((args, kw))
        return self.fn(*args, **kw)


@pytest.mark.parametrize("case", ["bf16", "int8_cache", "f32", "prefill"])
def test_routing(monkeypatch, case):
    dtype = torch.float32 if case == "f32" else torch.bfloat16
    cfg, layer = tiny_layer(dtype)
    S = 20 if case == "prefill" else 3
    x, cos, sin, cache, mask = layer_inputs(cfg, S, 48, "int8" if case == "int8_cache" else "bf16")
    wrapper, plain = Spy(da.decode_attention), Spy(da.decode_attention_reference)
    monkeypatch.setattr(pq, "decode_attention", wrapper)
    monkeypatch.setattr(pq, "decode_attention_reference", plain)
    before = da.LAUNCHES
    attn, new_cache = layer.attention_context(x, cos, sin, cache, 5, mask)
    assert attn.shape == (2, S, 4 * 16) and attn.dtype == dtype
    assert da.LAUNCHES == before
    if case == "bf16":
        assert len(wrapper.calls) == 1 and not plain.calls
        (q, k_all, v_all, m, scale), _ = wrapper.calls[0]
        assert k_all is new_cache[0] and v_all is new_cache[1] and m is mask
        assert torch.equal(attn, inline_branch(q, k_all, v_all, m))
    elif case in ("int8_cache", "f32"):
        assert not wrapper.calls and len(plain.calls) == 1
        args, kw = plain.calls[0]
        assert (args[5] is not None) == (case == "int8_cache")
        if case == "int8_cache":
            assert len(new_cache) == 4 and args[1] is new_cache[0]
    else:
        assert not wrapper.calls and not plain.calls


# -- the wrapper's checks -----------------------------------------------------

def meta(*shape, dtype=torch.bfloat16):
    return torch.empty(*shape, dtype=dtype, device="meta")


def meta_operands(B=2, S=1, H=32, KV=8, L=256, hd=128):
    return (meta(B, S, H, hd), meta(B, L, KV, hd), meta(B, L, KV, hd),
            meta(B, S, L, dtype=torch.float32))


@pytest.mark.parametrize("bad", ["q_dtype", "cache_dtype", "mask_dtype", "head_dim", "S17",
                                 "rows", "uneven_heads", "mask_shape", "strided_dim",
                                 "unaligned_rows"])
def test_wrapper_refuses(bad):
    q, k, v, m = meta_operands()
    if bad == "q_dtype":
        q = q.float()
    elif bad == "cache_dtype":
        k = k.to(torch.float16)
    elif bad == "mask_dtype":
        m = m.to(torch.bfloat16)
    elif bad == "head_dim":
        q, k, v, m = meta_operands(hd=64)
    elif bad == "S17":
        q, k, v, m = meta_operands(S=17)
    elif bad == "rows":
        q, k, v, m = meta_operands(S=16, H=64)     # 8 query heads a kv head x 16
    elif bad == "uneven_heads":
        q, k, v, m = meta_operands(H=30)
    elif bad == "mask_shape":
        m = meta(2, 1, 255, dtype=torch.float32)
    elif bad == "strided_dim":
        k = meta(2, 256, 8, 256)[..., ::2]
    elif bad == "unaligned_rows":
        v = meta(2, 256, 8, 132)[..., :128]
    with pytest.raises((TypeError, ValueError)):
        da.decode_attention(q, k, v, m, 0.1)


def test_wrapper_takes_strided_caches_and_masks():
    """A cache read through strides (a slice of a larger buffer) and an
    expanded mask pass the checks; without a card the call then refuses
    the device, never falling back."""
    q, _, _, _ = meta_operands()
    big = meta(2, 300, 8, 128)
    k, v = big[:, :256], meta(2, 256, 16, 128)[:, :, 8:]
    m = meta(1, 1, 256, dtype=torch.float32).expand(2, 1, 256)
    da.check_operands(q, k, v, m)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        da.decode_attention(q, k, v, m, 0.1)


def test_split_positions():
    # 8 slots x 8 kv heads over 2,240 positions on 132 SMs: 4 splits of 9 tiles
    assert da.split_positions(8, 8, 2240, 132) == 576
    # B = 1, and one card of tp = 2 (4 kv heads): 12 splits of the least, 3 tiles
    assert da.split_positions(1, 8, 2240, 132) == 192
    assert da.split_positions(1, 4, 2240, 132) == 192
    # a short cache is one split
    assert da.split_positions(1, 8, 16, 132) >= 16
    for B, KV, L in ((3, 8, 2112), (8, 2, 17), (16, 8, 4096)):
        chunk = da.split_positions(B, KV, L, 132)
        assert chunk % 64 == 0 and chunk == da.split_positions(B, KV, L, 132)
        assert -(-L // chunk) * B * KV <= 2 * 132 or chunk == 3 * 64


# -- the tiny judge's streams -------------------------------------------------

@pytest.fixture(scope="module")
def judge():
    """The judge backend over a tiny random Qwen3-VL in bf16 on the CPU,
    with the stub word tokenizer; ``rows`` collects each decoded row."""
    from emr2a_tpu_torch.judge.qwen_backend import QwenVLBackend
    from emr2a_tpu_torch.tools.stub_tokenizer import WordTokenizer

    config = pq.Qwen3VLConfig(
        vision=pq.QwenVisionConfig(
            depth=2, hidden_size=32, intermediate_size=64, num_heads=2, patch_size=16,
            temporal_patch_size=2, spatial_merge_size=2, out_hidden_size=64,
            num_position_embeddings=16, deepstack_visual_indexes=(0,),
            dtype=torch.bfloat16),
        text=pq.QwenTextConfig(
            vocab_size=151936, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
            head_dim=16, intermediate_size=128, mrope_section=(4, 2, 2),
            dtype=torch.bfloat16),
        image_token_id=151655, vision_start_token_id=151652)
    backend = QwenVLBackend(config=config, params=pq.random_state(config, 3, "cpu"),
                            tokenizer=WordTokenizer(), prompt_bucket=32, device="cpu",
                            decode_chunk=4)
    rows = []
    decode = backend._decode_row
    backend._decode_row = lambda row: rows.append(np.asarray(row).copy()) or decode(row)
    return backend, rows


def judge_requests(n):
    rng = np.random.RandomState(0)
    imgs = [Image.fromarray((rng.rand(64, 64, 3) * 255).astype(np.uint8)) for _ in range(n)]
    return [{"images": [img], "prompt": f"audit case {i}", "system": "be brief"}
            for i, img in enumerate(imgs)]


def streams(backend, rows, reqs):
    rows.clear()
    for r in reqs:
        backend.generate(r["images"], r["prompt"], system=r["system"], max_new_tokens=6)
    one = [r.copy() for r in rows]
    rows.clear()
    backend.generate_stream(reqs, max_new_tokens=6, n_slots=2)
    return one, [r.copy() for r in rows]


def test_judge_streams_unchanged(judge, monkeypatch):
    backend, rows = judge
    reqs = judge_requests(3)
    wrapper = Spy(da.decode_attention)
    monkeypatch.setattr(pq, "decode_attention", wrapper)
    got = streams(backend, rows, reqs)
    assert wrapper.calls and all(c[0][0].shape[1] <= 16 for c in wrapper.calls)

    def former(q, k, v, m, scale):
        assert scale == q.shape[-1] ** -0.5
        return inline_branch(q, k, v, m)

    monkeypatch.setattr(pq, "decode_attention", former)
    want = streams(backend, rows, reqs)
    for g, w in zip(got, want):
        assert len(g) == len(w) == 3
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    # the batched streams are the one-at-a-time streams
    for a, b in zip(*got):
        np.testing.assert_array_equal(a, b)
