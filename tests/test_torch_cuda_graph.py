"""The decode step replayed from a CUDA graph (``models/cuda_graph.py``) on
the card, at a small Qwen3-VL whose decoder projections the kernels take
(width 256, K5/K7's multiples of 128), in bf16:

- one replayed generator step against the same step run eagerly on a copy
  of the state, bit for bit (the KV cache written, the logits, the tokens),
  for bf16, int8 (K5) and int4 (K7) weights and the bf16 and int8 KV
  caches, greedy and sampled; ``generate``'s tokens (every step but the
  first replayed) against eager steps from the same start;
- the launch counts and forwards a replay adds: each step's K5 / K7 calls
  and one decoder forward, as the eager step counts them;
- the continuous batcher's first replayed chunk step of a later wave, on
  its kept slot state and graph, against its eager step, bit for bit, in
  the ring and the per-row layout, and that wave's rows against the first
  wave's;
- graphs kept for reuse: a run the warm-up finishes captures nothing; the
  generator's second generation of a shape only replays and equals the
  first, and its kept states stay within ``_KEPT_GRAPH_BYTES``;
- the speculative generator's cycle (``models/speculative.py``): one
  replayed cycle against the eager cycle on a copy of the state, bit for
  bit (both caches, the verify logits, the output, the counters), for bf16
  and int4 (K7) weights, the bf16 and int8 KV caches, greedy and sampled,
  with a self-draft and another draft; ``generate``'s tokens (chunks of
  replayed cycles, cycles past the end included) against eager cycles from
  the same start; a kept graph's second generation only replays; the
  batcher's speculative chunk cycle of a later wave against its eager
  cycle;
- ``cache_write``'s three branches (an int, a 0-d tensor, a (B,) vector of
  equal offsets) against each other, and the per-row branch with dropped
  positions against its result on the CPU;
- a step that reads a value back to the host fails its capture, and the
  failure raises; a capture survives garbage that holds an old graph (the
  collector runs before it and not during it).

Each test skips without a CUDA card. On the card:

    python -m pytest --noconftest tests/test_torch_cuda_graph.py -q
"""

import numpy as np
import pytest
import torch

from emr2a_tpu_torch.models import cuda_graph
from emr2a_tpu_torch.models import qwen3_vl as pq


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card with sm_90a (H100)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def small_config():
    return pq.Qwen3VLConfig(
        vision=pq.QwenVisionConfig(depth=1, hidden_size=64, intermediate_size=128,
                                   num_heads=2, patch_size=4, out_hidden_size=256,
                                   num_position_embeddings=64,
                                   deepstack_visual_indexes=(0,), dtype=torch.bfloat16),
        text=pq.QwenTextConfig(vocab_size=1024, hidden_size=256, num_layers=2, num_heads=2,
                               num_kv_heads=1, head_dim=128, intermediate_size=512,
                               mrope_section=(24, 20, 20), tie_word_embeddings=False,
                               dtype=torch.bfloat16))


_STATES = {}


def small_model(precision: str):
    from emr2a_tpu_torch.judge.qwen_backend import quantize_decoder
    if "bf16" not in _STATES:
        state = pq.random_state(small_config(), seed=0, device="cuda")
        # weights of std 0.02 give near-uniform logits at this width; 0.2
        # keeps the greedy tokens away from ties
        _STATES["bf16"] = {k: v * 10 if k.endswith("kernel") or k.endswith("embedding")
                           else v for k, v in state.items()}
    return pq.Qwen3VLModel.from_params(small_config(),
                                       quantize_decoder(_STATES["bf16"], precision))


IDS = np.array([[3, 5, 8, 13, 21, 34, 55, 89, 144, 6, 7]], np.int64)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("precision", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_replayed_step_equals_eager_step(cuda, precision, kv_dtype, temperature):
    from emr2a_tpu_torch.ops import linear_int4, linear_int8
    model = small_model(precision)
    gen = pq.Qwen3VLGenerator(model, eos_token_id=-1, kv_dtype=kv_dtype)
    kw = dict(temperature=temperature, top_p=0.9, seed=3, prompt_bucket=16)
    with torch.inference_mode():
        state = gen.start(np.repeat(IDS, 2, axis=0), steps=12, **kw)
        eager = cuda_graph.clone_state(state)
        runner = cuda_graph.StepGraph(gen.decode_step, state, cuda,
                                      forwards=(model.language_model,))
        counters = {m: m.LAUNCHES for m in (linear_int8, linear_int4)}
        forwards = cuda_graph.replayed_forwards(model.language_model)
        runner.run(4)                        # the warm-up, then 3 replays
        assert runner.graph is not None and runner.replays == 3
        calls = {m: m.LAUNCHES - n for m, n in counters.items()}
        n_proj = 7 * len(model.language_model.layers)
        per_step = {"bf16": (0, 0), "int8": (n_proj, 0), "int4": (0, n_proj)}[precision]
        assert (calls[linear_int8], calls[linear_int4]) == tuple(4 * n for n in per_step)
        assert cuda_graph.replayed_forwards(model.language_model) - forwards == 3
        for _ in range(4):
            gen.decode_step(eager)
        torch.cuda.synchronize()
        for (path, a), (_, b) in zip(cuda_graph.state_tensors(state),
                                     cuda_graph.state_tensors(eager)):
            assert torch.equal(a, b), path
        assert cuda_graph.replay_matches_eager(runner) == []
        tokens = gen.generate(IDS, max_new_tokens=9, **kw)
        ref = gen.start(IDS, steps=9, **kw)
        for _ in range(9):
            gen.decode_step(ref)
        np.testing.assert_array_equal(tokens, ref.out.cpu().numpy())


@pytest.mark.parametrize("ring", [True, False])
@pytest.mark.parametrize("precision", ["bf16", "int4"])
def test_batcher_replayed_step_equals_eager_step(cuda, precision, ring):
    from emr2a_tpu_torch.models import serving
    model = small_model(precision)
    srv = serving.ContinuousBatcher(model, n_slots=3, prompt_bucket=16, max_new_tokens=10,
                                    eos_token_id=-1, chunk=4, ring_decode=ring,
                                    kv_dtype="int8")
    reqs = [{"input_ids": IDS[:, :n]} for n in (5, 11, 8, 3)]
    reqs[1].update(temperature=0.8, seed=2)
    rows = srv.serve(reqs, max_new_tokens=10)
    assert [r.shape for r in rows] == [(10,)] * 4
    runner, captures = srv._runners[True], cuda_graph.CAPTURES
    runner.verify = True
    again = srv.serve(reqs, max_new_tokens=10)
    assert runner.mismatches == [] and srv._runners[True] is runner
    assert cuda_graph.CAPTURES == captures
    for a, b in zip(again, rows):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("precision", ["bf16", "int4"])
def test_replayed_spec_cycle_equals_eager_cycle(cuda, precision, kv_dtype, temperature):
    from emr2a_tpu_torch.models.speculative import SpeculativeGenerator
    from emr2a_tpu_torch.ops import linear_int4
    model = small_model(precision)
    other = pq.Qwen3VLModel.from_params(small_config(), {
        k: (v.flip(0) if k.endswith("kernel") else v) for k, v in model.state_dict().items()})
    for draft in (model, other):
        spec = SpeculativeGenerator(model, draft, spec_k=3, eos_token_id=-1, kv_dtype=kv_dtype)
        kw = dict(temperature=temperature, top_p=0.9, seed=3, prompt_bucket=16)
        with torch.inference_mode():
            state = spec.start(IDS, max_new_tokens=16, **kw)
            eager = cuda_graph.clone_state(state)
            runner = cuda_graph.StepGraph(spec.cycle, state, cuda,
                                          forwards=(model.language_model,))
            calls = linear_int4.LAUNCHES
            runner.run(3)                        # the warm-up, then 2 replays
            per_cycle = 7 * 2 * (3 + 1 + 1) if precision == "int4" and draft is model else None
            if per_cycle:
                assert linear_int4.LAUNCHES - calls == 3 * per_cycle
            for _ in range(3):
                spec.cycle(eager)
            torch.cuda.synchronize()
            for (path, a), (_, b) in zip(cuda_graph.state_tensors(state),
                                         cuda_graph.state_tensors(eager)):
                assert torch.equal(a, b), path
            assert cuda_graph.replay_matches_eager(runner) == []
            tokens = spec.generate(IDS, max_new_tokens=12, chunk=4, **kw)
            ref = spec.start(IDS, max_new_tokens=12, **kw)
            for _ in range(11):
                spec.cycle(ref)
            want = ref.out.cpu().numpy()[:12]
            n = int(ref.n_emitted)
            np.testing.assert_array_equal(tokens[0, :min(n, 12)], want[:min(n, 12)])
            captures = cuda_graph.CAPTURES
            np.testing.assert_array_equal(spec.generate(IDS, max_new_tokens=12, chunk=4, **kw),
                                          tokens)
            assert cuda_graph.CAPTURES == captures and len(spec._graphs) == 1
        if temperature == 0 and draft is model:
            plain = pq.Qwen3VLGenerator(model, eos_token_id=-1, kv_dtype=kv_dtype)
            assert int(ref.accepted) > 0
            assert plain.generate(IDS, max_new_tokens=12, prompt_bucket=16).shape == tokens.shape


@pytest.mark.parametrize("precision", ["bf16", "int4"])
def test_spec_batcher_replayed_cycle_equals_eager_cycle(cuda, precision):
    from emr2a_tpu_torch.models import serving
    model = small_model(precision)
    srv = serving.ContinuousBatcher(model, n_slots=3, prompt_bucket=16, max_new_tokens=10,
                                    eos_token_id=-1, chunk=2, kv_dtype="int8",
                                    draft_model=model, spec_k=3)
    reqs = [{"input_ids": IDS[:, :n]} for n in (5, 11, 8, 3)]
    reqs[1].update(temperature=0.8, seed=2)
    rows = srv.serve(reqs, max_new_tokens=10)
    assert [r.shape for r in rows] == [(10,)] * 4
    runner, captures = srv._runners["spec", True], cuda_graph.CAPTURES
    runner.verify = True
    again = srv.serve(reqs, max_new_tokens=10)
    assert runner.mismatches == [] and srv._runners["spec", True] is runner
    assert cuda_graph.CAPTURES == captures
    for a, b in zip(again, rows):
        np.testing.assert_array_equal(a, b)


def test_capture_waits_for_the_first_replay(cuda):
    x = torch.zeros(4, device=cuda)
    runner = cuda_graph.StepGraph(lambda t: t.add_(1.0), x, cuda)
    runner.run(1)                                  # the warm-up alone
    assert runner.graph is None and runner.steps == 1
    runner.run(3)
    assert runner.graph is not None and runner.replays == 3 and runner.steps == 4
    assert torch.equal(x, torch.full((4,), 4.0, device=cuda))


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_generator_keeps_its_graphs(cuda, monkeypatch, temperature):
    model = small_model("int4")
    gen = pq.Qwen3VLGenerator(model, eos_token_id=-1)
    kw = dict(temperature=temperature, top_p=0.9, seed=3, prompt_bucket=16)
    with torch.inference_mode():
        ref = gen.start(IDS, steps=9, **kw)
        for _ in range(9):
            gen.decode_step(ref)
    captures = cuda_graph.CAPTURES
    first = gen.generate(IDS, max_new_tokens=9, **kw)
    assert cuda_graph.CAPTURES == captures + 1 and len(gen._graphs) == 1
    np.testing.assert_array_equal(gen.generate(IDS, max_new_tokens=9, **kw), first)
    np.testing.assert_array_equal(first, ref.out.cpu().numpy())
    other = gen.generate(IDS[:, :7], max_new_tokens=9, **kw)     # refilled, replayed
    assert cuda_graph.CAPTURES == captures + 1 and len(gen._graphs) == 1
    gen.generate(IDS, max_new_tokens=5, **kw)
    assert cuda_graph.CAPTURES == captures + 2 and len(gen._graphs) == 2
    one = pq.cache_bytes(next(iter(gen._graphs.values())).state.cache)
    monkeypatch.setattr(pq, "_KEPT_GRAPH_BYTES", one)
    np.testing.assert_array_equal(gen.generate(IDS[:, :7], max_new_tokens=9, **kw), other)
    assert len(gen._graphs) == 1
    gen.release()
    assert not gen._graphs


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8, torch.float32])
def test_cache_write_branches_agree(cuda, dtype):
    gen = torch.Generator(device="cuda").manual_seed(0)
    buf = (torch.randn(3, 20, 2, 8, generator=gen, device="cuda") * 50).to(dtype)
    fresh = (torch.randn(3, 4, 2, 8, generator=gen, device="cuda") * 50).to(dtype)
    outs = [pq.cache_write(buf.clone(), fresh, pos) for pos in (
        7, torch.tensor(7, device="cuda"), torch.full((3,), 7, device="cuda"))]
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
    pos = torch.tensor([0, 18, 25], device="cuda")        # row 1 drops 2, row 2 all
    got = pq.cache_write(buf.clone(), fresh, pos)
    want = pq.cache_write(buf.cpu(), fresh.cpu(), pos.cpu())
    assert torch.equal(got.cpu(), want)
    assert torch.equal(got[2], buf[2]) and torch.equal(got[1, 18:], fresh[1, :2])


def test_failed_capture_raises(cuda):
    x = torch.ones(4, device=cuda)
    runner = cuda_graph.StepGraph(lambda t: t.add_(float(t.sum())), x, cuda)
    with pytest.raises(RuntimeError):
        runner.run(2)
    torch.cuda.synchronize()


def test_capture_survives_a_collectable_graph(cuda):
    """An old graph kept in a reference cycle (as a generator keeps its
    graphs) becomes garbage; a capture that follows is not invalidated by
    the collector freeing it."""
    import gc

    class Owner:
        def step(self, t):
            t.mul_(2.0)

    for _ in range(3):
        owner = Owner()
        owner.runner = cuda_graph.StepGraph(owner.step, torch.ones(256, device=cuda), cuda)
        owner.runner.run(3)
        del owner                                   # a cycle: only the collector frees it
    threshold = gc.get_threshold()
    gc.set_threshold(1)                             # collect at nearly every allocation
    try:
        x = torch.ones(256, device=cuda)
        runner = cuda_graph.StepGraph(lambda t: t.add_(torch.ones_like(t)), x, cuda)
        runner.run(4)
    finally:
        gc.set_threshold(*threshold)
    assert runner.graph is not None and torch.equal(x, torch.full((256,), 5.0, device=cuda))

