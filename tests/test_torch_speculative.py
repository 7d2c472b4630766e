"""The port's speculative generator (``emr2a_tpu_torch/models/speculative.py``)
on the CPU, at the JAX suite's tiny geometry (``tests/test_speculative.
tiny_config``: 2 layers, width 64, f32), with the weights of flax inits
loaded through the port's converter.

- The greedy ``SpeculativeGenerator`` emits exactly the port's plain greedy
  ``Qwen3VLGenerator`` rows (JAX's cases): the self-draft, an independent
  draft (seed 7), the int8 KV cache, W8A8 and W4A8 target and draft, an
  eos stop and a multimodal prompt.
- Against JAX's ``SpeculativeGenerator`` on the same weights: identical
  rows for a greedy and an int8-KV case.
- B > 1 raises as in JAX; the vocabulary, ``spec_k`` and ``kv_dtype`` are
  checked as in JAX.
- The no-op guard: a cycle run after the row finished changes neither the
  output nor any KV row, where the same cycle without the guard (its
  writes at the cursor through ``cache_write``'s 0-d offset) would clamp
  into the visible prefix.
"""

import numpy as np
import pytest
import torch

from emr2a_tpu.models.speculative import SpeculativeGenerator as JaxSpeculative
from emr2a_tpu_torch.models import qwen3_vl as pq
from emr2a_tpu_torch.models.convert import params_from_jax, params_to_jax
from emr2a_tpu_torch.models.quantize import quantize_qwen_text_params
from emr2a_tpu_torch.models.speculative import SpeculativeGenerator
from tests.test_speculative import PROMPT, init_params, tiny_config
from tests.test_torch_serving import port_config

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def models():
    """{seed: (JAX model, JAX params, port model)} from flax inits."""
    out = {}
    for seed in (0, 3, 5, 7, 9):
        jm, jp = init_params(tiny_config(), seed, with_vision=True)
        out[seed] = jm, jp, pq.Qwen3VLModel.from_params(port_config(), params_from_jax(jp))
    return out


def quantized(model, precision):
    tree = params_to_jax(model.state_dict())
    tree["language_model"] = quantize_qwen_text_params(tree["language_model"],
                                                       precision=precision)
    return pq.Qwen3VLModel.from_params(port_config(), params_from_jax(tree))


def plain(model, ids=PROMPT, eos=-1, kv_dtype="bf16", max_new=12, **kw):
    return pq.Qwen3VLGenerator(model, eos_token_id=eos, kv_dtype=kv_dtype).generate(
        ids, max_new_tokens=max_new, prompt_bucket=16, **kw)


@pytest.mark.parametrize("draft_seed,k,kv_dtype,precision", [
    (0, 3, "bf16", None),          # self-draft: every proposal accepted
    (7, 3, "bf16", None),          # independent draft: about none accepted
    (3, 2, "int8", None),
    (7, 3, "bf16", "int8"),
    (7, 2, "bf16", "int4"),
])
def test_speculative_equals_plain_greedy(models, draft_seed, k, kv_dtype, precision):
    target, draft = models[0][2], models[draft_seed][2]
    if precision:
        target, draft = quantized(target, precision), quantized(draft, precision)
    want = plain(target, kv_dtype=kv_dtype)
    spec = SpeculativeGenerator(target, draft, spec_k=k, eos_token_id=-1, kv_dtype=kv_dtype)
    np.testing.assert_array_equal(spec.generate(PROMPT, max_new_tokens=12, prompt_bucket=16,
                                                chunk=3), want)


def test_speculative_acceptance_counts(models):
    """The self-draft accepts every proposal (k + 1 tokens a cycle); the
    state's counters say so."""
    model = models[0][2]
    spec = SpeculativeGenerator(model, model, spec_k=3, eos_token_id=-1)
    s = spec.start(PROMPT, max_new_tokens=12, prompt_bucket=16)
    while int(s.n_emitted) < 12:
        spec.cycle(s)
    assert int(s.cycles) == 3 and int(s.accepted) == 9 and int(s.n_emitted) == 13


def test_speculative_eos_stop(models):
    target, draft = models[0][2], models[5][2]
    eos = int(plain(target, max_new=8)[0][2])     # the third token stops the stream
    want = plain(target, eos=eos, max_new=8)
    spec = SpeculativeGenerator(target, draft, spec_k=3, eos_token_id=eos)
    got = spec.generate(PROMPT, max_new_tokens=8, prompt_bucket=16)
    np.testing.assert_array_equal(got, want)
    assert (got[0, 2:] == eos).all()


def test_speculative_multimodal(models):
    target, draft = models[0][2], models[9][2]
    rng = np.random.RandomState(0)
    pixels = rng.randn(16, 4 * 4 * 3).astype(np.float32)
    ids = np.array([[5, 6] + [120] * 4 + [9, 2]], np.int64)
    kw = dict(pixel_patches=pixels, grid_thw=((1, 4, 4),), max_new_tokens=8, prompt_bucket=16)
    want = pq.Qwen3VLGenerator(target, eos_token_id=-1).generate(ids, **kw)
    spec = SpeculativeGenerator(target, draft, spec_k=2, eos_token_id=-1)
    np.testing.assert_array_equal(spec.generate(ids, **kw), want)


@pytest.mark.parametrize("kv_dtype,k", [("bf16", 3), ("int8", 2)])
def test_speculative_equals_jax(models, kv_dtype, k):
    jt, jtp, target = models[0]
    _, jdp, draft = models[7]
    want = JaxSpeculative(jt, jtp, jt, jdp, spec_k=k, eos_token_id=-1,
                          kv_dtype=kv_dtype).generate(PROMPT, max_new_tokens=10,
                                                      prompt_bucket=16)
    got = SpeculativeGenerator(target, draft, spec_k=k, eos_token_id=-1,
                               kv_dtype=kv_dtype).generate(PROMPT, max_new_tokens=10,
                                                           prompt_bucket=16)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_speculative_rejects_what_jax_rejects(models):
    model = models[0][2]
    spec = SpeculativeGenerator(model, model)
    with pytest.raises(ValueError, match="B=1"):
        spec.generate(np.zeros((2, 4), np.int64), max_new_tokens=4)
    with pytest.raises(ValueError, match="spec_k"):
        SpeculativeGenerator(model, model, spec_k=0)
    with pytest.raises(ValueError, match="kv_dtype"):
        SpeculativeGenerator(model, model, kv_dtype="fp8")
    import dataclasses
    other = pq.Qwen3VLConfig(vision=port_config().vision, image_token_id=120,
                             text=dataclasses.replace(port_config().text, vocab_size=64))
    with pytest.raises(ValueError, match="vocabulary"):
        SpeculativeGenerator(model, pq.Qwen3VLModel(other, device="meta"))


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_finished_cycle_is_a_no_op(models, temperature):
    """Cycles run after the row has emitted max_new tokens change nothing:
    not the output, the counters, nor any row of either cache. The self-
    draft finishes at n_emitted = max_new + k, where the unguarded cycle's
    writes would start past the cache's end (at padded + n - 1) and clamp
    back into its visible prefix."""
    model, k, max_new = models[0][2], 3, 6
    spec = SpeculativeGenerator(model, model, spec_k=k, eos_token_id=-1)
    s = spec.start(PROMPT, max_new_tokens=max_new, prompt_bucket=16,
                   temperature=temperature, seed=4)
    while int(s.n_emitted) < max_new:
        spec.cycle(s)
    n = int(s.n_emitted)
    if temperature == 0:
        assert n == max_new + k            # 1 + 4 + 4: two cycles of k + 1
        unguarded = s.padded_len + n - 1
        assert unguarded + k + 1 > s.max_len        # it would have clamped
        assert s.max_len - (k + 1) < s.padded_len + n - 1   # into the visible prefix
    before = [t.clone() for t in (s.out, s.n_emitted, s.done, s.logits, s.cycles,
                                  s.accepted)]
    caches = [b.clone() for layer in s.t_cache + s.d_cache for b in layer]
    for _ in range(3):
        spec.cycle(s)
    after = [s.out, s.n_emitted, s.done, s.logits, s.cycles, s.accepted]
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert all(torch.equal(a, b) for a, b in zip(
        caches, [b for layer in s.t_cache + s.d_cache for b in layer]))
