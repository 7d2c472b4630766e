"""Sampled speculative decoding in the port is distribution-exact: JAX's
``tests/test_sampled_speculative.py`` laws, on the port's counter-based
``spec_accept`` and ``SpeculativeGenerator`` (CPU, the JAX suite's tiny
geometry).

1. ``spec_accept`` run as many independent trials (one row each, keys from
   ``stream_keys``) emits a first token distributed as the target p, not
   the draft q, for self, independent and disjoint-support drafts (total
   variation < 0.02 at 20,000 trials, JAX's bar), and its second position
   follows p too (< 0.03); with point-mass (greedy) rows it is the longest
   argmax-matching prefix whatever the key.
2. ``SpeculativeGenerator`` with temperature > 0 repeats its tokens for a
   seed and explores with another; its per-position marginals match the
   plain sampler's over 400 seeds within JAX's total variation of 0.15;
   temperature 0 takes the greedy path whatever the seed.
"""

import numpy as np
import pytest
import torch

from emr2a_tpu_torch.models import qwen3_vl as pq
from emr2a_tpu_torch.models.convert import params_from_jax
from emr2a_tpu_torch.models.speculative import SpeculativeGenerator
from tests.test_speculative import PROMPT, init_params, tiny_config
from tests.test_torch_serving import port_config

torch.set_num_threads(1)


def spec_accept_trials(q, p, n, k, seed=0):
    """n independent spec_accept rounds (one row each) with drafts drawn
    from q; every position shares q and p. Returns (emitted, n_acc)."""
    q_t, p_t = torch.from_numpy(q).double(), torch.from_numpy(p).double()
    q_lp = torch.where(q_t > 0, torch.log(q_t.clamp(min=1e-30)), float("-inf")).float()
    p_lp = torch.where(p_t > 0, torch.log(p_t.clamp(min=1e-30)), float("-inf")).float()
    gen = torch.Generator().manual_seed(seed)
    drafts = torch.multinomial(q_t.float().expand(n * k, -1), 1, generator=gen).view(n, k)
    keys = pq.stream_keys(torch.arange(n) + 7919 * seed, 0)
    emitted, n_acc = pq.spec_accept(drafts, q_lp.expand(n, k, -1), p_lp.expand(n, k + 1, -1),
                                    keys)
    return emitted.numpy(), n_acc.numpy()


@pytest.mark.parametrize("case", ["self", "independent", "disjoint"])
def test_spec_accept_first_token_is_target_distributed(case):
    rng = np.random.RandomState(3)
    V, N, k = 8, 20000, 3
    p = rng.dirichlet(np.ones(V)).astype(np.float32)
    if case == "self":
        q = p.copy()
    else:
        q = rng.dirichlet(np.ones(V)).astype(np.float32)
        if case == "disjoint":           # the draft never proposes p's heaviest token
            q[p.argmax()] = 0.0
            q = q / q.sum()
    emitted, n_acc = spec_accept_trials(q, p, N, k)
    freq = np.bincount(emitted[:, 0], minlength=V) / N
    tv = 0.5 * np.abs(freq - p).sum()
    assert tv < 0.02, (case, tv, freq, p)
    if case == "self":
        assert (n_acc == k).all()


def test_spec_accept_second_position_law():
    rng = np.random.RandomState(4)
    V, N, k = 6, 20000, 2
    p = rng.dirichlet(np.ones(V)).astype(np.float32)
    q = rng.dirichlet(np.ones(V)).astype(np.float32)
    emitted, n_acc = spec_accept_trials(q, p, N, k, seed=9)
    mask = n_acc >= 1
    freq = np.bincount(emitted[mask, 1], minlength=V) / mask.sum()
    assert 0.5 * np.abs(freq - p).sum() < 0.03


def test_spec_accept_greedy_point_mass_is_the_prefix_match():
    V, k = 10, 3
    rng = np.random.RandomState(5)
    t_logits = torch.from_numpy(rng.randn(k + 1, V).astype(np.float32))
    d_logits = torch.from_numpy(rng.randn(k, V).astype(np.float32))
    d_logits[0] = t_logits[0]            # the first proposal matches
    q_lp = pq.filtered_log_probs(d_logits, torch.zeros(k), torch.ones(k))
    p_lp = pq.filtered_log_probs(t_logits, torch.zeros(k + 1), torch.ones(k + 1))
    drafts = d_logits.argmax(-1)[None]
    t_arg, d_arg = t_logits.argmax(-1), d_logits.argmax(-1)
    want = 0
    while want < k and d_arg[want] == t_arg[want]:
        want += 1
    assert want >= 1
    for seed in range(4):                # the key must not matter
        emitted, n_acc = pq.spec_accept(drafts, q_lp[None], p_lp[None],
                                        pq.stream_keys(torch.tensor([seed]), 0))
        assert int(n_acc[0]) == want
        assert int(emitted[0, want]) == int(t_arg[want])
        assert emitted[0, :want].tolist() == d_arg[:want].tolist()


@pytest.fixture(scope="module")
def pair():
    """(target, independent draft) from the JAX suite's flax inits (seeds 0
    and 7)."""
    return tuple(pq.Qwen3VLModel.from_params(
        port_config(), params_from_jax(init_params(tiny_config(), s, with_vision=True)[1]))
        for s in (0, 7))


def test_sampled_speculative_deterministic_per_seed(pair):
    spec = SpeculativeGenerator(*pair, spec_k=2, eos_token_id=-1)
    kw = dict(max_new_tokens=6, prompt_bucket=16, temperature=0.7, top_p=0.9)
    a = spec.generate(PROMPT, seed=13, **kw)
    b = spec.generate(PROMPT, seed=13, **kw)
    c = spec.generate(PROMPT, seed=14, **kw)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


def test_sampled_speculative_marginals_match_plain_sampler(pair):
    """Per-position marginals of the speculative sampled path (an
    independent draft: real rejections) against the plain sampler's, over
    400 seeds each, within JAX's total variation of 0.15."""
    temp, top_p, n_seeds, n_tok = 0.3, 0.9, 400, 3
    target, draft = pair
    gen = pq.Qwen3VLGenerator(target, eos_token_id=-1)
    spec = SpeculativeGenerator(target, draft, spec_k=2, eos_token_id=-1)
    kw = dict(max_new_tokens=n_tok, prompt_bucket=16, temperature=temp, top_p=top_p)
    plain_toks = np.stack([gen.generate(PROMPT, seed=1000 + s, **kw)[0]
                           for s in range(n_seeds)])
    spec_toks = np.stack([spec.generate(PROMPT, seed=2000 + s, **kw)[0]
                          for s in range(n_seeds)])
    V = port_config().text.vocab_size
    for pos in range(n_tok):
        f_plain = np.bincount(plain_toks[:, pos], minlength=V) / n_seeds
        f_spec = np.bincount(spec_toks[:, pos], minlength=V) / n_seeds
        assert 0.5 * np.abs(f_plain - f_spec).sum() < 0.15, pos


def test_sampled_speculative_greedy_key_unchanged(pair):
    target, _ = pair
    draft = pq.Qwen3VLModel.from_params(
        port_config(), params_from_jax(init_params(tiny_config(), 5, with_vision=True)[1]))
    spec = SpeculativeGenerator(target, draft, spec_k=3, eos_token_id=-1)
    want = pq.Qwen3VLGenerator(target, eos_token_id=-1).generate(
        PROMPT, max_new_tokens=8, prompt_bucket=16)
    for seed in (3, 99):
        np.testing.assert_array_equal(
            spec.generate(PROMPT, max_new_tokens=8, prompt_bucket=16, temperature=0.0,
                          seed=seed), want)
