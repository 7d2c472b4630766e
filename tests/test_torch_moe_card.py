"""K11 (``ops/moe.py``, the routed experts of Kimi-VL's expert layers) on the
card, against its plain version ``moe_reference``, at the published widths
(64 experts of 1,408 at hidden 2,048, top 6):

- decode: 16 slots (96 pairs) and B = 1 (6 pairs), eager and replayed from
  a CUDA graph whose routing changes in place between replays;
- a 16 x 2,510-token prefill (40,160 tokens, 240,960 pairs);
- every pair on one expert, and pairs on only some experts (the others
  empty);
- the device-side tally (pairs, calls, distinct experts, largest load)
  against the routing's own counts, and ``LAUNCHES``.

Tolerance: the kernel and the plain version round at the same points (the
SwiGLU product to bf16, the rest in f32) but sum in another order, so an
element of ``h`` may land one bf16 ulp apart; the outputs are held to
1e-2 of the largest magnitude and a row cosine of at least 0.9999, and
the two paths of one device bit for bit (eager against graph replay).

Each test skips without a CUDA card. On the card (the suite's conftest
imports JAX, which that machine lacks):

    python -m pytest --noconftest tests/test_torch_moe_card.py -q
"""

import pytest
import torch

from emr2a_tpu_torch.ops import moe

E, D, I, K = 64, 2048, 1408, 6


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card with sm_90a (H100)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture()
def weights(cuda):
    g = torch.Generator(device="cuda").manual_seed(0)
    gu = (torch.randn(E, D, 2 * I, generator=g, device="cuda") * 0.02).to(torch.bfloat16)
    down = (torch.randn(E, I, D, generator=g, device="cuda") * 0.02).to(torch.bfloat16)
    return gu, down


def routing(T, seed=1, experts=None):
    """Random top-6 ids (distinct a token) over ``experts`` (default all)
    and normalised weights times 2.446."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    pool = torch.arange(E, device="cuda") if experts is None else torch.as_tensor(
        experts, device="cuda")
    scores = torch.rand(T, len(pool), generator=g, device="cuda")
    ids = pool[torch.topk(scores, min(K, len(pool)), dim=-1).indices]
    w = torch.rand(T, ids.shape[1], generator=g, device="cuda") + 0.1
    return ids, (w / w.sum(-1, keepdim=True) * 2.446).float()


def inputs(T, seed=2):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(T, D, generator=g, device="cuda").to(torch.bfloat16)


def close(out, ref):
    assert torch.isfinite(out).all()
    scale = ref.abs().max().item()
    assert (out - ref).abs().max().item() <= 1e-2 * scale
    cos = torch.nn.functional.cosine_similarity(out, ref, dim=-1)
    assert cos.min().item() >= 0.9999


@pytest.mark.parametrize("T", [16, 1])
def test_decode_against_plain(weights, T):
    gu, down = weights
    x, (ids, w) = inputs(T), routing(T)
    before = moe.LAUNCHES
    out = moe.moe_experts(x, gu, down, ids, w, "decode")
    assert moe.LAUNCHES == before + 1
    close(out, moe.moe_reference(x, gu, down, ids, w))


@pytest.mark.parametrize("T", [16, 1])
def test_decode_graph_replay(weights, T):
    gu, down = weights
    x, (ids, w) = inputs(T), routing(T)
    eager = moe.moe_experts(x, gu, down, ids, w, "decode")
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        moe.moe_experts(x, gu, down, ids, w, "decode")      # warm-up off the graph
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = moe.moe_experts(x, gu, down, ids, w, "decode")
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    for seed in (5, 6):
        ids2, w2 = routing(T, seed)
        x2 = inputs(T, seed)
        ids.copy_(ids2)
        w.copy_(w2)
        x.copy_(x2)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, moe.moe_experts(x, gu, down, ids, w, "decode"))
        close(out, moe.moe_reference(x, gu, down, ids, w))


def test_prefill_refill_wave(weights):
    gu, down = weights
    T = 16 * 2510
    x, (ids, w) = inputs(T), routing(T)
    close(moe.moe_experts(x, gu, down, ids, w), moe.moe_reference(x, gu, down, ids, w))


@pytest.mark.parametrize("T", [16, 3000])
def test_all_pairs_on_one_expert(weights, T):
    gu, down = weights
    x = inputs(T)
    ids = torch.full((T, K), 37, device="cuda")
    w = torch.full((T, K), 2.446 / K, device="cuda")
    close(moe.moe_experts(x, gu, down, ids, w), moe.moe_reference(x, gu, down, ids, w))


@pytest.mark.parametrize("T", [16, 600])
def test_some_experts_empty(weights, T):
    gu, down = weights
    x, (ids, w) = inputs(T), routing(T, experts=[0, 5, 6, 7, 20, 33, 63])
    close(moe.moe_experts(x, gu, down, ids, w), moe.moe_reference(x, gu, down, ids, w))


def test_tally(weights):
    gu, down = weights
    t = moe.tally("cuda")
    t.zero_()
    runs = [(16, routing(16, 3)), (1, routing(1, 4)), (700, routing(700, 9, [1, 2, 3, 4, 5, 6]))]
    for T, (ids, w) in runs:
        moe.moe_experts(inputs(T), gu, down, ids, w, "decode" if T <= 16 else "prefill")
    got = moe._read_tally(t)
    for phase, sel in (("decode", runs[:2]), ("prefill", runs[2:])):
        counts = [torch.bincount(ids.reshape(-1), minlength=E) for _, (ids, _) in sel]
        assert got[f"moe.pairs.{phase}"] == sum(T * K for T, _ in sel)
        assert got[f"moe.calls.{phase}"] == len(sel)
        assert got[f"moe.expert_reads.{phase}"] == sum(int((c > 0).sum()) for c in counts)
        assert got[f"moe.max_load.{phase}"] == max(int(c.max()) for c in counts)


def test_refuses_what_it_does_not_take(weights):
    gu, down = weights
    x, (ids, w) = inputs(4), routing(4)
    with pytest.raises(TypeError):
        moe.moe_experts(x.float(), gu, down, ids, w)
    with pytest.raises(ValueError):
        moe.moe_experts(x, gu, down, ids[:, :3], w)
