"""Tensor-parallel serving in the port (``models/qwen3_vl.py``'s
``Qwen3VLGenerator(mesh=)``, ``models/serving.py``'s
``ContinuousBatcher(mesh=)``, ``models/speculative.py`` over sharded
models, ``judge/qwen_backend.py``'s ``tp=``) on an 8-device CPU mesh of
(4, 2), at the JAX serving suite's tiny geometry (``tests/test_speculative.
tiny_config``), one seeded random state (``tests/test_torch_tp.tiny_state``)
loaded into both packages.

The contract is JAX's (``tests/test_serving_tp.py``): the mesh changes
where the math runs, never what it computes, so every token stream equals
the one-card stream: the generator (bf16 and int8 KV cache, chunked
prefill, a multimodal prompt, sampling), JAX's own tp run on the same
weights, the continuous batcher (more requests than slots, refills
mid-wave, int8 KV, shared-prefix waves), the speculative generator and
the batcher's speculative chunk over a sharded target and draft, and
``QwenVLBackend(tp=2)``'s ``generate_batch`` / ``generate_stream`` /
``generate`` (with a draft). The slot cache is placed on its kv heads.
"""

import jax
import jax.tree_util as jtu
import numpy as np
import pytest
import torch

from emr2a_tpu.models.qwen3_vl import Qwen3VLGenerator as JaxGenerator
from emr2a_tpu.models.qwen3_vl import Qwen3VLModel as JaxQwen3VLModel
from emr2a_tpu.parallel.mesh import create_mesh as jax_create_mesh
from emr2a_tpu.training import param_shardings as jax_param_shardings
from emr2a_tpu_torch.models import qwen3_vl as pq
from emr2a_tpu_torch.models import serving as ps
from emr2a_tpu_torch.models.convert import params_to_jax
from emr2a_tpu_torch.models.speculative import SpeculativeGenerator
from emr2a_tpu_torch.parallel import create_mesh, force_cpu_devices
from emr2a_tpu_torch.parallel import mesh as port_mesh
from tests.test_speculative import tiny_config
from tests.test_torch_serving import (
    assert_rows,
    multimodal_request,
    plain_rows,
    port_config,
    prefix_requests,
    text_requests,
)
from tests.test_torch_tp import tiny_state

torch.set_num_threads(1)
CPU8 = [torch.device("cpu")] * 8


@pytest.fixture(scope="module")
def tiny():
    """(JAX model, JAX params, port model, the port model sharded over
    (4, 2))."""
    state = tiny_state()
    jparams = params_to_jax({k: v.numpy() for k, v in state.items()})
    model = pq.Qwen3VLModel.from_params(port_config(), state)
    mesh = create_mesh((4, 2), devices=CPU8)
    return JaxQwen3VLModel(tiny_config()), jparams, model, pq.tensor_parallel(model, mesh)


def generate(model, req, n, **kw):
    return pq.Qwen3VLGenerator(model, eos_token_id=-1, **kw).generate(
        np.asarray(req["input_ids"]).reshape(1, -1), pixel_patches=req.get("pixel_patches"),
        grid_thw=tuple(req.get("grid_thw", ()) or ()), max_new_tokens=n, prompt_bucket=16)


@pytest.mark.parametrize("kw", [dict(kv_dtype="bf16"), dict(kv_dtype="int8"),
                                dict(prefill_chunk=4)],
                         ids=["bf16_kv", "int8_kv", "chunked_prefill"])
def test_generator_tp_token_parity(tiny, mesh8, kw):
    jmodel, jparams, model, tp = tiny
    req = text_requests(1, seed=11 if "prefill_chunk" not in kw else 13)[0]
    want = generate(model, req, 8, **kw)
    got = pq.Qwen3VLGenerator(model, eos_token_id=-1, mesh=tp.mesh, **kw)
    assert isinstance(got.model, pq.ShardedQwen3VLModel) and not got.replays
    np.testing.assert_array_equal(got.generate(req["input_ids"], max_new_tokens=8,
                                               prompt_bucket=16), want)
    np.testing.assert_array_equal(generate(tp, req, 8, **kw), want)
    # JAX's tp run on the same weights (JAX's generator takes kv_dtype and
    # prefill_chunk as the port's does)
    jmesh = jax_create_mesh((4, 2))
    sharded = jtu.tree_map(jax.device_put, jparams, jax_param_shardings(jparams, jmesh))
    jgen = JaxGenerator(jmodel, sharded, eos_token_id=-1, mesh=jmesh, **kw)
    np.testing.assert_array_equal(np.asarray(jgen.generate(
        np.asarray(req["input_ids"]), max_new_tokens=8, prompt_bucket=16)), want)


def test_generator_tp_multimodal_and_sampled(tiny):
    _, _, model, tp = tiny
    req = multimodal_request(np.random.RandomState(4))
    np.testing.assert_array_equal(generate(tp, req, 6), generate(model, req, 6))
    ids = np.concatenate([r["input_ids"] for r in text_requests(2, seed=3)][:1] * 2)
    kw = dict(max_new_tokens=7, temperature=0.8, top_p=0.9, seed=5, prompt_bucket=16)
    np.testing.assert_array_equal(
        pq.Qwen3VLGenerator(tp, eos_token_id=-1).generate(ids, **kw),
        pq.Qwen3VLGenerator(model, eos_token_id=-1).generate(ids, **kw))


def test_batcher_tp_token_parity(tiny):
    """More requests than slots, slots at different depths, refills
    mid-wave; and int8 KV with a multimodal request among text ones."""
    _, _, model, tp = tiny
    reqs = text_requests(5, seed=17)
    srv = ps.ContinuousBatcher(model, n_slots=2, prompt_bucket=16, max_new_tokens=8,
                               eos_token_id=-1, chunk=3, mesh=tp.mesh)
    assert isinstance(srv.model, pq.ShardedQwen3VLModel)
    assert_rows(srv.serve(reqs, max_new_tokens=8), plain_rows(model, reqs, [8] * 5, eos=-1))
    reqs = text_requests(3, seed=6) + [multimodal_request(np.random.RandomState(2))]
    srv = ps.ContinuousBatcher(tp, n_slots=3, prompt_bucket=16, max_new_tokens=6,
                               eos_token_id=-1, chunk=2, kv_dtype="int8")
    assert_rows(srv.serve(reqs, max_new_tokens=6),
                plain_rows(model, reqs, [6] * 4, eos=-1, kv_dtype="int8"))
    # the slot cache is placed on its kv heads: one part a card, its int8
    # values (B, L, KV / 2, HD) and scales (B, L, KV / 2)
    cache = srv._state["cache"]
    assert isinstance(cache, pq.ShardedCache) and len(cache) == 2
    assert [tuple(b.shape) for b in cache[1][0]] == [(3, 26, 1, 16), (3, 26, 1),
                                                     (3, 26, 1, 16), (3, 26, 1)]


def test_batcher_tp_shared_prefix_parity(tiny):
    """A shared-prefix wave on the mesh: the once-a-wave prefix cache and
    its broadcast to the refill rows stay head-sharded and token-exact."""
    _, _, model, tp = tiny
    reqs = prefix_requests(4, prefix_len=20, seed=23)
    srv = ps.ContinuousBatcher(tp, n_slots=2, prompt_bucket=32, max_new_tokens=7,
                               eos_token_id=-1, chunk=3)
    shared = []
    real = srv._prefill_shared_prefix

    def spy(requests):
        real(requests)
        shared.append((srv._wave_lp, srv._wave_prefix))

    srv._prefill_shared_prefix = spy
    assert_rows(srv.serve(reqs, max_new_tokens=7),
                plain_rows(model, reqs, [7] * 4, eos=-1, bucket=32))
    lp, prefix = shared[0]
    assert lp == 20 and isinstance(prefix, pq.ShardedCache)
    assert srv._wave_lp == 0


def test_speculative_tp_target_and_draft(tiny):
    """The speculative generator and the batcher's speculative chunk over a
    target and a draft both sharded over the mesh: the target's greedy
    streams."""
    _, jparams, model, tp = tiny
    draft = pq.Qwen3VLModel.from_params(port_config(), tiny_state(7))
    tp_draft = pq.tensor_parallel(draft, tp.mesh)
    req = text_requests(1, seed=9)[0]
    want = generate(model, req, 9)
    got = SpeculativeGenerator(tp, tp_draft, spec_k=3, eos_token_id=-1).generate(
        req["input_ids"], max_new_tokens=9, prompt_bucket=16)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="same mesh"):
        SpeculativeGenerator(tp, draft, spec_k=3, eos_token_id=-1)
    reqs = text_requests(4, seed=12)
    srv = ps.ContinuousBatcher(model, n_slots=2, prompt_bucket=16, max_new_tokens=8,
                               eos_token_id=-1, chunk=2, draft_model=draft, spec_k=2,
                               mesh=tp.mesh)
    assert srv.draft_model.mesh is tp.mesh
    assert_rows(srv.serve(reqs, max_new_tokens=8), plain_rows(model, reqs, [8] * 4, eos=-1))


def _backend(tp, **kw):
    from emr2a_tpu_torch.encoders.qwen3_vl_encoder import make_image_processor
    from emr2a_tpu_torch.judge.qwen_backend import QwenVLBackend
    from emr2a_tpu_torch.tools.stub_tokenizer import WordTokenizer
    cfg = pq.Qwen3VLConfig(
        vision=pq.QwenVisionConfig(depth=2, hidden_size=32, intermediate_size=64,
                                   num_heads=2, patch_size=4, out_hidden_size=48,
                                   num_position_embeddings=64, deepstack_visual_indexes=(0,)),
        text=pq.QwenTextConfig(vocab_size=151936, hidden_size=48, num_layers=2, num_heads=4,
                               num_kv_heads=2, head_dim=12, intermediate_size=96,
                               mrope_section=(2, 2, 2), tie_word_embeddings=False))
    state = pq.random_state(cfg, seed=0, device="cpu")
    return QwenVLBackend(config=cfg, params=state, tokenizer=WordTokenizer(),
                         image_processor=make_image_processor(cfg.vision, min_pixels=16,
                                                              max_pixels=16384),
                         prompt_bucket=32, tp=tp, **kw)


def test_backend_tp_matches_single_device():
    """step4 ``--tp 2``'s composition: the backend builds the (4, 2) mesh
    over the 8 devices and shards its params; generate_batch and
    generate_stream (and generate through a self-draft) give tp = 1's text,
    the vision tower and multimodal KV included."""
    rng = np.random.RandomState(0)
    img = (rng.rand(16, 16, 3) * 255).astype(np.uint8)
    requests = [{"images": [img], "prompt": p}
                for p in ("describe", "what is this", "findings please")]
    saved = port_mesh._default_mesh
    try:
        force_cpu_devices(8)
        plain = _backend(1, precision="int8")
        be = _backend(2, precision="int8")
    finally:
        port_mesh.set_default_mesh(saved)
    assert be.mesh.shape == {"data": 4, "model": 2}
    want = plain.generate_batch(requests, max_new_tokens=6)
    assert be.generate_batch(requests, max_new_tokens=6) == want
    assert be.generate_stream(requests, max_new_tokens=6, n_slots=2) == want
    # a self-draft over the same mesh: the speculative path's text
    be.spec_generator = SpeculativeGenerator(be.model, be.model, spec_k=2,
                                             eos_token_id=be.generator.eos_token_id)
    assert be.generate([img], "describe", max_new_tokens=6) == want[0]
