"""The port's continuous batcher (``emr2a_tpu_torch/models/serving.py``) on
the CPU, at the JAX serving suite's tiny geometry (``tests/test_speculative.
tiny_config``: 2 layers, width 64, f32), with the weights of one flax init
loaded into both packages through the port's converter.

- Against the port's generator at B = 1 (the JAX suite's oracle), token
  rows equal exactly: more requests than slots, staggered prompt lengths,
  eos stops and per-request budgets, the int8 KV cache, chunked refill
  prefill, multimodal rows among text rows, the shared prefix (text, a
  multimodal suffix, int8 with chunked prefill), the ring layout against
  the per-row layout, ``_fit_chunk``'s collapse to auto, the refill-batch
  policy and the overlong-prompt rejection.
- Against JAX's ``ContinuousBatcher`` on the same weights: a staggered
  greedy wave and an int8-KV wave give identical token rows.
- Mixed sampling: greedy rows equal the plain generator's; sampled rows
  repeat for their seed, lie in ``filtered_log_probs``' support at every
  step, and give the same stream served alone, at another slot, or beside
  other requests (and the generator's at B = 1 with the same seed); the
  counter-based streams' draws follow the filtered distribution.
"""

import numpy as np
import pytest
import torch

from emr2a_tpu.models.qwen3_vl import Qwen3VLGenerator as JaxGenerator
from emr2a_tpu.models.serving import ContinuousBatcher as JaxBatcher
from emr2a_tpu_torch.models import qwen3_vl as pq
from emr2a_tpu_torch.models import serving as ps
from emr2a_tpu_torch.models.convert import params_from_jax
from tests.test_speculative import init_params, tiny_config

torch.set_num_threads(1)


def port_config():
    """``tiny_config()``'s geometry in the port's config classes."""
    return pq.Qwen3VLConfig(
        vision=pq.QwenVisionConfig(
            depth=2, hidden_size=32, intermediate_size=64, num_heads=2, patch_size=4,
            temporal_patch_size=1, spatial_merge_size=2, out_hidden_size=64,
            num_position_embeddings=64, deepstack_visual_indexes=(0,)),
        text=pq.QwenTextConfig(
            vocab_size=128, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
            head_dim=16, intermediate_size=96, mrope_section=(4, 2, 2)),
        image_token_id=120)


@pytest.fixture(scope="module")
def tiny():
    """(JAX model, JAX params, port model) from one flax init."""
    jmodel, jparams = init_params(tiny_config(), 0, with_vision=True)
    return jmodel, jparams, pq.Qwen3VLModel.from_params(port_config(),
                                                        params_from_jax(jparams))


def plain_rows(model, requests, budgets, eos, kv_dtype="bf16", bucket=16):
    gen = pq.Qwen3VLGenerator(model, eos_token_id=eos, kv_dtype=kv_dtype)
    return [gen.generate(np.asarray(r["input_ids"]).reshape(1, -1),
                         pixel_patches=r.get("pixel_patches"),
                         grid_thw=tuple(r.get("grid_thw", ()) or ()),
                         max_new_tokens=b, prompt_bucket=bucket)[0]
            for r, b in zip(requests, budgets)]


def text_requests(n, seed=0):
    rng = np.random.RandomState(seed)
    return [{"input_ids": rng.randint(2, 100, (1, 5 + (i * 3) % 9), np.int64)}
            for i in range(n)]


def prefix_requests(n, prefix_len=17, seed=0):
    rng = np.random.RandomState(seed)
    prefix = rng.randint(2, 100, (prefix_len,), np.int64)
    return [{"input_ids": np.concatenate(
        [prefix, rng.randint(2, 100, (3 + (i * 2) % 7,), np.int64)])[None]}
        for i in range(n)]


def multimodal_request(rng, prefix=(5, 6), suffix=(9, 2)):
    n_img = 4 * 4 // (2 * 2)
    return {"input_ids": np.array([list(prefix) + [120] * n_img + list(suffix)], np.int64),
            "pixel_patches": rng.randn(16, 4 * 4 * 3).astype(np.float32),
            "grid_thw": ((1, 4, 4),)}


def assert_rows(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")


def batcher(model, **kw):
    kw = {"n_slots": 2, "prompt_bucket": 16, "eos_token_id": -1, **kw}
    return ps.ContinuousBatcher(model, **kw)


# -- against the port's generator at B = 1 ------------------------------------

@pytest.mark.parametrize("case", ["more_requests_than_slots", "int8_kv", "chunked_prefill"])
def test_continuous_matches_plain(tiny, case):
    model = tiny[2]
    reqs, n, kw = {
        "more_requests_than_slots": (text_requests(7), 10, dict(n_slots=3, chunk=4)),
        "int8_kv": (text_requests(4, seed=5), 8, dict(kv_dtype="int8", chunk=4)),
        "chunked_prefill": (text_requests(5, seed=7), 9, dict(chunk=4, prefill_chunk=4)),
    }[case]
    want = plain_rows(model, reqs, [n] * len(reqs), -1, kw.get("kv_dtype", "bf16"))
    assert_rows(batcher(model, max_new_tokens=n, **kw).serve(reqs, max_new_tokens=n), want)


def test_continuous_eos_and_budgets(tiny):
    """A real emitted token as eos, so rows stop at different chunks and
    slots refill; per-request budgets."""
    model = tiny[2]
    reqs = text_requests(5, seed=3)
    probe = pq.Qwen3VLGenerator(model, eos_token_id=-1)
    eos = int(probe.generate(reqs[0]["input_ids"], max_new_tokens=12, prompt_bucket=16)[0][3])
    budgets = [12, 4, 12, 7, 12]
    for r, b in zip(reqs, budgets):
        r["max_new_tokens"] = b
    want = plain_rows(model, reqs, budgets, eos)
    got = batcher(model, max_new_tokens=12, eos_token_id=eos, chunk=3).serve(reqs)
    assert_rows(got, want)
    assert any(eos in row[:-1] for row in got)          # some row stopped early


def test_continuous_multimodal_mixed_with_text(tiny):
    model = tiny[2]
    mm = multimodal_request(np.random.RandomState(0))
    reqs = [mm] + text_requests(2, seed=8) + [dict(mm)]
    want = plain_rows(model, reqs, [6] * 4, -1)
    assert_rows(batcher(model, max_new_tokens=6, chunk=2).serve(reqs, max_new_tokens=6), want)


def test_shared_prefix_matches_plain(tiny):
    model = tiny[2]
    reqs = prefix_requests(5)
    want = plain_rows(model, reqs, [9] * 5, -1, bucket=32)
    srv = batcher(model, prompt_bucket=32, max_new_tokens=9, chunk=3)
    assert srv._shared_prefix_len(reqs) == 17
    assert_rows(srv.serve(reqs, max_new_tokens=9), want)
    assert 17 in srv._prefix_fns                     # sharing ran
    # the wave's prefix goes, the slot state stays for the next wave
    assert srv._wave_prefix is None and srv._wave_lp == 0 and srv._state is not None
    off = batcher(model, prompt_bucket=32, max_new_tokens=9, chunk=3, shared_prefix=False)
    assert_rows(off.serve(reqs, max_new_tokens=9), want)
    assert not off._prefix_fns


def test_shared_prefix_multimodal_suffix(tiny):
    """The shared text prefix under rows whose images lie in the suffix."""
    model = tiny[2]
    rng = np.random.RandomState(0)
    prefix = tuple(rng.randint(2, 100, (18,)))
    reqs = [multimodal_request(rng, prefix, (9 + i, 2)) for i in range(4)]
    want = plain_rows(model, reqs, [7] * 4, -1, bucket=32)
    srv = batcher(model, prompt_bucket=32, max_new_tokens=7, chunk=2)
    assert srv._shared_prefix_len(reqs) == 18
    assert_rows(srv.serve(reqs, max_new_tokens=7), want)
    assert 18 in srv._prefix_fns


def test_shared_prefix_int8_kv_and_chunked(tiny):
    model = tiny[2]
    reqs = prefix_requests(4, prefix_len=20, seed=2)
    want = plain_rows(model, reqs, [8] * 4, -1, kv_dtype="int8", bucket=32)
    srv = batcher(model, prompt_bucket=32, max_new_tokens=8, chunk=3, kv_dtype="int8",
                  prefill_chunk=8)
    assert srv._fit_chunk(12, 1) == 6      # the suffix 32 - 20 = 12: divisor 6
    assert_rows(srv.serve(reqs, max_new_tokens=8), want)


def test_fit_chunk_collapse_falls_back_to_auto(tiny):
    model = tiny[2]
    srv = batcher(model, prompt_bucket=32, max_new_tokens=8, prefill_chunk=8)
    assert srv._fit_chunk(12, 1) == 6
    assert srv._fit_chunk(13, 1) != 1 and srv._fit_chunk(31, 1) != 1
    reqs = prefix_requests(4, prefix_len=19, seed=11)     # a prime suffix, 13
    assert_rows(srv.serve(reqs, max_new_tokens=8),
                plain_rows(model, reqs, [8] * 4, -1, bucket=32))


def test_shared_prefix_detection_rules(tiny):
    srv = batcher(tiny[2], prompt_bucket=32, max_new_tokens=4)
    base = list(range(2, 22))
    rows = lambda seqs: [{"input_ids": np.array([s], np.int64)} for s in seqs]
    with_img = base[:18] + [120] * 6 + base[18:]
    assert srv._shared_prefix_len(rows([with_img + [30], with_img + [31]])) == 18
    early = base[:10] + [120] * 6 + base[10:]
    assert srv._shared_prefix_len(rows([early + [30], early + [31]])) == 0
    assert srv._shared_prefix_len(rows([base, base + [50]])) == len(base) - 1
    assert srv._shared_prefix_len(rows([base])) == 0
    assert srv._shared_prefix_len(rows([[5, 6, 7, 8], [5, 6, 7, 9]])) == 0


def test_refill_batch_policy_resolution(tiny):
    model = tiny[2]
    srv = batcher(model, n_slots=3, max_new_tokens=4)
    srv.serve(text_requests(2), max_new_tokens=2)
    assert srv.refill_batch == 3                      # short suffix: batch
    long_bucket = ps._BATCH_REFILL_MAX_SUFFIX + 16
    srv2 = batcher(model, n_slots=3, prompt_bucket=long_bucket, max_new_tokens=4)
    srv2.serve(text_requests(2), max_new_tokens=2)
    assert srv2.refill_batch == 1                     # long suffix: serialize
    rng = np.random.RandomState(0)
    prefix = rng.randint(2, 100, (long_bucket - 32,), np.int64)
    preqs = [{"input_ids": np.concatenate([prefix, rng.randint(2, 100, (4 + i,),
                                                               np.int64)])[None]}
             for i in range(2)]
    srv3 = batcher(model, n_slots=3, prompt_bucket=long_bucket, max_new_tokens=4)
    srv3.serve(preqs, max_new_tokens=2)
    assert srv3.refill_batch == 3                     # the shared prefix shrinks it
    srv4 = batcher(model, n_slots=3, max_new_tokens=4, refill_batch=1)
    srv4.serve(text_requests(2), max_new_tokens=2)
    assert srv4.refill_batch == 1


def test_ring_decode_matches_per_row_layout(tiny):
    """Token-identical across refills, mixed sampling and the ring's
    wrap-around (7 requests over 2 slots run the step counter past R)."""
    model = tiny[2]
    reqs = text_requests(7, seed=11)
    reqs[2]["temperature"] = 0.9
    reqs[5]["temperature"] = 0.7
    kw = dict(max_new_tokens=9, chunk=3)
    ring = batcher(model, **kw)
    flat = batcher(model, ring_decode=False, **kw)
    assert ring.ring_decode and not flat.ring_decode
    assert_rows(ring.serve(reqs, max_new_tokens=9), flat.serve(reqs, max_new_tokens=9))


def test_kept_state_serves_later_waves_like_a_fresh_batcher(tiny):
    """The slot state (and on a card its graphs) stays between waves and is
    re-zeroed: a later wave on it equals the same wave on a new batcher;
    ``release`` drops it."""
    model = tiny[2]
    rng = np.random.RandomState(4)
    first = text_requests(5, seed=30)
    first[1].update(temperature=0.8, seed=7)
    later = text_requests(3, seed=31) + [multimodal_request(rng)]
    later[0].update(temperature=0.9, top_p=0.8, seed=3)
    kw = dict(n_slots=3, max_new_tokens=9, chunk=3, kv_dtype="int8")
    srv = batcher(model, **kw)
    srv.serve(first, max_new_tokens=9)
    state = srv._state
    assert state is not None and set(srv._runners) == {True}
    got = srv.serve(later, max_new_tokens=9)
    assert srv._state is state
    assert_rows(got, batcher(model, **kw).serve(later, max_new_tokens=9))
    srv.release()
    assert srv._state is None and srv._runners == {}
    assert_rows(srv.serve(later, max_new_tokens=9), got)


def test_generator_start_refills_a_used_state(tiny):
    """``start(into=)`` writes a new prompt's prefill into a used state of
    the same shape: its decode equals a fresh state's, greedy and sampled."""
    gen = pq.Qwen3VLGenerator(tiny[2], eos_token_id=-1, kv_dtype="int8")
    a, b = (r["input_ids"] for r in text_requests(2, seed=40))
    for kw in (dict(), dict(temperature=0.8, top_p=0.9, seed=5)):
        used = gen.start(a, steps=6, prompt_bucket=16, **kw)
        for _ in range(6):
            gen.decode_step(used)
        fresh = gen.start(b, steps=6, prompt_bucket=16, **kw)
        assert gen.start(b, steps=6, prompt_bucket=16, into=used, **kw) is used
        for _ in range(6):
            gen.decode_step(used)
            gen.decode_step(fresh)
        assert torch.equal(used.out, fresh.out) and torch.equal(used.logits, fresh.logits)


def test_continuous_rejects_overlong_prompt_and_unported_options(tiny):
    srv = batcher(tiny[2], prompt_bucket=8, max_new_tokens=4)
    with pytest.raises(ValueError, match="bucket"):
        srv.serve([{"input_ids": np.zeros((1, 9), np.int64)}], max_new_tokens=4)
    assert srv._state is None                         # released on failure too
    # tensor parallelism is ported (tests/test_torch_serving_tp.py); a mesh
    # that is not the port's parallel.Mesh raises
    with pytest.raises(TypeError, match="parallel.Mesh"):
        batcher(tiny[2], mesh=object())
    # a draft is ported (tests/test_torch_spec_serving.py): its wave equals
    # JAX's speculative batcher's, and its options are checked as JAX's are
    jmodel, jparams, model = tiny
    reqs = text_requests(3, seed=2)
    kw = dict(n_slots=2, prompt_bucket=16, max_new_tokens=6, eos_token_id=-1, chunk=2,
              spec_k=2)
    want = JaxBatcher(jmodel, jparams, draft_model=jmodel, draft_params=jparams, **kw).serve(
        reqs, max_new_tokens=6)
    assert_rows(ps.ContinuousBatcher(model, draft_model=model, **kw).serve(
        reqs, max_new_tokens=6), [np.asarray(w) for w in want])
    with pytest.raises(ValueError, match="spec_k"):
        batcher(model, draft_model=model, spec_k=0)


# -- sampling -----------------------------------------------------------------

def test_continuous_mixed_sampling(tiny, monkeypatch):
    model = tiny[2]
    greedy = text_requests(2, seed=11)
    sampled = [dict(r, temperature=0.9, top_p=0.8, seed=100 + i)
               for i, r in enumerate(text_requests(2, seed=13))]
    reqs = [greedy[0], sampled[0], greedy[1], sampled[1]]
    draws, outside = [], []
    real = pq.sample_rows

    def checked(logits, keys, temp, top_p):
        tok = real(logits, keys, temp, top_p)
        lp = pq.filtered_log_probs(logits, temp, top_p)
        rows = temp > 0
        draws.append(int(rows.sum()))
        outside.append(int((~torch.isfinite(lp.gather(1, tok[:, None]))[rows]).sum()))
        return tok

    monkeypatch.setattr(ps, "sample_rows", checked)
    srv = batcher(model, n_slots=3, max_new_tokens=9, chunk=3)
    got = srv.serve(reqs, max_new_tokens=9)
    assert sum(draws) > 0 and sum(outside) == 0
    monkeypatch.setattr(ps, "sample_rows", real)
    assert_rows([got[0], got[2]], plain_rows(model, greedy, [9, 9], -1))
    assert_rows(srv.serve(reqs, max_new_tokens=9), got)            # repeatable
    assert not np.array_equal(got[1], got[3])
    # the same stream alone, at another slot beside other requests, and from
    # the generator at B = 1 with the request's seed
    alone = batcher(model, n_slots=3, max_new_tokens=9, chunk=3).serve([sampled[1]], 9)
    moved = batcher(model, n_slots=3, max_new_tokens=9, chunk=4).serve(
        text_requests(3, seed=20) + [sampled[1]] + [greedy[0]], 9)
    np.testing.assert_array_equal(alone[0], got[3])
    np.testing.assert_array_equal(moved[3], got[3])
    gen = pq.Qwen3VLGenerator(model, eos_token_id=-1).generate(
        sampled[1]["input_ids"], max_new_tokens=9, prompt_bucket=16, temperature=0.9,
        top_p=0.8, seed=101)
    np.testing.assert_array_equal(gen[0], got[3])


# -- against JAX's ContinuousBatcher ------------------------------------------

@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_continuous_equals_jax_batcher(tiny, kv_dtype):
    """A staggered greedy wave (prompt lengths 5 to 13, more requests than
    slots, refills mid-stream) in both packages on the same weights."""
    jmodel, jparams, model = tiny
    reqs = text_requests(5, seed=21)
    kw = dict(n_slots=2, prompt_bucket=16, max_new_tokens=8, eos_token_id=-1,
              kv_dtype=kv_dtype, chunk=4)
    want = JaxBatcher(jmodel, jparams, **kw).serve(reqs, max_new_tokens=8)
    assert_rows(ps.ContinuousBatcher(model, **kw).serve(reqs, max_new_tokens=8),
                [np.asarray(w) for w in want])
    if kv_dtype == "bf16":     # and the generators agree, the oracle of both suites
        jgen = JaxGenerator(jmodel, jparams, eos_token_id=-1)
        np.testing.assert_array_equal(
            plain_rows(model, reqs[:1], [8], -1)[0],
            np.asarray(jgen.generate(reqs[0]["input_ids"], max_new_tokens=8,
                                     prompt_bucket=16))[0])


def test_counter_streams_follow_the_filtered_distribution():
    """The keys a generation draws with (``draw_keys`` of per-row
    ``stream_keys`` over the steps): 20,000 draws a row, one a step of 40
    streams, within a total variation of 0.03 of exp(filtered_log_probs),
    the bar ``test_torch_qwen3_vl_options.py`` holds generator-drawn keys
    to."""
    rng = np.random.RandomState(5)
    x = torch.from_numpy((rng.randn(3, 120) * [[0.5], [2.0], [6.0]]).astype(np.float32))
    temp, top_p = torch.tensor([0.7, 1.0, 1.5]), torch.tensor([0.9, 1.0, 0.7])
    want = torch.exp(pq.filtered_log_probs(x, temp, top_p))
    streams = pq.stream_keys(torch.arange(40).repeat_interleave(3), torch.arange(3).repeat(40))
    n, counts = 20_000, torch.zeros_like(want)
    for step in range(n // 40):
        tok = pq.sample_rows(x.repeat(40, 1), pq.draw_keys(streams, step), temp.repeat(40),
                             top_p.repeat(40))
        counts.index_put_((torch.arange(3).repeat(40), tok), torch.ones(tok.shape[0]),
                          accumulate=True)
    tv = 0.5 * (counts / n - want).abs().sum(dim=-1)
    assert (tv < 0.03).all(), tv
