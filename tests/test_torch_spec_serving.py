"""The port's speculative continuous batching (``ContinuousBatcher(...,
draft_model=...)``, ``models/serving.py``) on the CPU, at the JAX serving
suite's tiny geometry, with the weights of flax inits loaded through the
port's converter.

- Greedy rows equal the port's plain generator at B = 1 exactly (and so
  the plain batcher's, ring and per-row layouts alike): staggered prompt
  lengths with more requests than slots, eos stops and per-request
  budgets, the int8 KV cache, a shared prefix with a multimodal row, for
  the self-draft and an independent draft.
- Against JAX's ``ContinuousBatcher(draft_model=...)``: one greedy wave,
  identical rows.
- Mixed sampling: greedy rows stay exact; every token a sampled row emits
  lies in the target's filtered support (checked inside ``spec_accept``
  and the inserts' first draws) and the rows repeat for their seeds.
"""

import numpy as np
import pytest
import torch

from emr2a_tpu.models.serving import ContinuousBatcher as JaxBatcher
from emr2a_tpu_torch.models import qwen3_vl as pq
from emr2a_tpu_torch.models import serving as ps
from emr2a_tpu_torch.models import speculative as psp
from emr2a_tpu_torch.models.convert import params_from_jax
from tests.test_speculative import init_params, tiny_config
from tests.test_torch_serving import (
    assert_rows,
    batcher,
    multimodal_request,
    plain_rows,
    port_config,
    text_requests,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pair():
    """(JAX model, JAX target params, JAX draft params, port target, port
    draft) from the flax inits of seeds 0 and 7."""
    jm, jt = init_params(tiny_config(), 0, with_vision=True)
    _, jd = init_params(tiny_config(), 7, with_vision=True)
    port = [pq.Qwen3VLModel.from_params(port_config(), params_from_jax(p)) for p in (jt, jd)]
    return (jm, jt, jd, *port)


@pytest.mark.parametrize("self_draft", [True, False])
@pytest.mark.parametrize("case", ["staggered", "eos_budgets", "int8_kv", "prefix_mm"])
def test_speculative_batcher_equals_plain(pair, case, self_draft):
    model = pair[3]
    draft = model if self_draft else pair[4]
    kw = dict(n_slots=3, chunk=2, max_new_tokens=10, draft_model=draft, spec_k=3)
    eos, bucket, budgets = -1, 16, None
    if case == "staggered":
        reqs = text_requests(7)
    elif case == "eos_budgets":
        reqs = text_requests(5, seed=3)
        probe = pq.Qwen3VLGenerator(model, eos_token_id=-1)
        eos = int(probe.generate(reqs[0]["input_ids"], max_new_tokens=10,
                                 prompt_bucket=16)[0][3])
        budgets = [10, 4, 10, 1, 7]
        for r, b in zip(reqs, budgets):
            r["max_new_tokens"] = b
    elif case == "int8_kv":
        reqs = text_requests(4, seed=5)
        kw.update(kv_dtype="int8", spec_k=2)
    else:
        rng = np.random.RandomState(0)
        prefix = tuple(rng.randint(2, 100, (18,)))
        reqs = [multimodal_request(rng, prefix, (9 + i, 2)) for i in range(2)] + [
            {"input_ids": np.array([list(prefix) + [30 + i, 31, 32][:2 + i]], np.int64)}
            for i in range(2)]
        bucket = 32
    budgets = budgets or [10] * len(reqs)
    want = plain_rows(model, reqs, budgets, eos, kw.get("kv_dtype", "bf16"), bucket=bucket)
    srv = batcher(model, eos_token_id=eos, prompt_bucket=bucket, **kw)
    assert not srv.ring_decode and srv.max_len == bucket + 10 + 2 * 2 * (kw["spec_k"] + 1)
    assert_rows(srv.serve(reqs, max_new_tokens=10), want)
    if case == "staggered":       # the plain batcher's layouts agree with it
        for ring in (True, False):
            assert_rows(batcher(model, n_slots=3, chunk=2, max_new_tokens=10,
                                ring_decode=ring).serve(reqs, max_new_tokens=10), want)
    if case == "prefix_mm":
        assert srv._shared_prefix_len(reqs) == 18 and (18, True) in srv._prefix_fns
    if case == "eos_budgets":
        assert any(eos in row[:-1] for row in want)


def test_speculative_batcher_equals_jax(pair):
    jm, jt, jd, model, draft = pair
    reqs = text_requests(5, seed=21)
    kw = dict(n_slots=2, prompt_bucket=16, max_new_tokens=8, eos_token_id=-1, chunk=2,
              spec_k=3)
    want = JaxBatcher(jm, jt, draft_model=jm, draft_params=jd, **kw).serve(
        reqs, max_new_tokens=8)
    got = ps.ContinuousBatcher(model, draft_model=draft, **kw).serve(reqs, max_new_tokens=8)
    assert_rows(got, [np.asarray(w) for w in want])


def test_speculative_batcher_mixed_sampling(pair, monkeypatch):
    model, draft = pair[3], pair[4]
    greedy = text_requests(2, seed=11)
    sampled = [dict(r, temperature=0.9, top_p=0.8, seed=100 + i)
               for i, r in enumerate(text_requests(2, seed=13))]
    reqs = [greedy[0], sampled[0], greedy[1], sampled[1]]
    checked = {"emitted": 0, "outside": 0, "first": 0}
    real_accept, real_sample = psp.spec_accept, ps.sample_rows

    def accept(drafts, q_lp, p_lp, keys):
        emitted, n_acc = real_accept(drafts, q_lp, p_lp, keys)
        valid = torch.arange(emitted.shape[1])[None, :] <= n_acc[:, None]
        finite = torch.isfinite(p_lp.gather(2, emitted[:, :, None])[..., 0])
        checked["emitted"] += int(valid.sum())
        checked["outside"] += int((valid & ~finite).sum())
        return emitted, n_acc

    def sample(logits, keys, temp, top_p):
        tok = real_sample(logits, keys, temp, top_p)
        lp = pq.filtered_log_probs(logits, temp, top_p)
        checked["first"] += tok.shape[0]
        checked["outside"] += int((~torch.isfinite(lp.gather(1, tok[:, None]))).sum())
        return tok

    # the cycle's draws and acceptance run in speculative.draft_and_verify,
    # each request's first draw in the batcher's insert
    monkeypatch.setattr(psp, "spec_accept", accept)
    monkeypatch.setattr(psp, "sample_rows", sample)
    monkeypatch.setattr(ps, "sample_rows", sample)
    srv = batcher(model, n_slots=3, chunk=2, max_new_tokens=9, draft_model=draft, spec_k=2)
    got = srv.serve(reqs, max_new_tokens=9)
    assert checked["emitted"] > 0 and checked["first"] > 0 and checked["outside"] == 0
    assert set(srv._runners) == {("spec", True)}
    assert_rows([got[0], got[2]], plain_rows(model, greedy, [9, 9], -1))
    assert_rows(srv.serve(reqs, max_new_tokens=9), got)               # repeatable
    assert not np.array_equal(got[1], got[3])
    alone = batcher(model, n_slots=3, chunk=2, max_new_tokens=9, draft_model=draft,
                    spec_k=2).serve([sampled[1]], 9)
    np.testing.assert_array_equal(alone[0], got[3])       # a stream is its seed's
