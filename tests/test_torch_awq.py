"""The port's AWQ (``emr2a_tpu_torch/models/awq.py``) against JAX's
``emr2a_tpu/models/awq.py`` on the CPU, at ``tests/test_awq.tiny_model``'s
geometry (2 layers, width 64, GQA 4/2, f32), on the same weights:

- ``collect_awq_stats``: every layer's and site's (amax, mean square)
  within 1e-5 of JAX's, batches merged the same way;
- ``compute_awq_scales``: JAX's alpha at every site, its scales and its
  errors (awq and rtn) allclose;
- ``fold_awq_scales`` keeps the f32 logits (rtol = atol = 2e-4, JAX's
  ``test_fold_is_output_preserving``) with arbitrary group-shared scales;
- the whole pipeline on the outlier-embedding fixture: JAX's alphas, and
  its int4 codes equal to JAX's (the count of differing codes is asserted
  0), its group scales and folded norm scales within 1e-6 (the two
  packages' statistics differ in their last bits, as their sums run in
  other orders, and so do the candidate scales built from them; the fold
  itself is bit for bit JAX's on equal scales);
- on that fixture AWQ's logits cosine to the f32 model is at least RTN's
  less 1e-4 and above 0.97, and every site's AWQ error is at most its RTN
  error, as JAX's test holds;
- ``tools/awq_depth`` (the card's AWQ gate) on that fixture: the fixture
  bit for bit JAX's, the fold alone output-preserving, int4_awq at least
  RTN's less 1e-4.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from emr2a_tpu.models import awq as jax_awq
from emr2a_tpu.models.quantize import quantize_qwen_text_params as jax_quantize
from emr2a_tpu_torch.models import awq
from emr2a_tpu_torch.models import qwen3_vl as pq
from emr2a_tpu_torch.models.convert import params_from_jax, params_to_jax
from emr2a_tpu_torch.models.quantize import quantize_qwen_text_params
from tests.test_awq import _forward_logits, _outlier_embed, tiny_model

torch.set_num_threads(1)


def port_config():
    return pq.Qwen3VLConfig(
        vision=pq.QwenVisionConfig(depth=1, hidden_size=32, out_hidden_size=64, num_heads=2,
                                   patch_size=4, temporal_patch_size=1, spatial_merge_size=2,
                                   intermediate_size=48, num_position_embeddings=64,
                                   deepstack_visual_indexes=(0,)),
        text=pq.QwenTextConfig(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
                               num_kv_heads=2, head_dim=16, intermediate_size=96,
                               mrope_section=(4, 2, 2)),
        image_token_id=250)


def port_state(jparams):
    """The JAX text-only tree's tensors over a state that has the (unused)
    vision tower's too."""
    state = pq.random_state(port_config(), seed=0, device="cpu")
    state.update(params_from_jax(jparams))
    return state


def port_logits(state, ids):
    model = pq.Qwen3VLModel.from_params(port_config(), state)
    ids = torch.as_tensor(np.asarray(ids))
    B, S = ids.shape
    pos = torch.arange(S)[None, None].expand(3, B, S)
    with torch.inference_mode():
        return model(ids, pos)[0].double().numpy()


@pytest.fixture(scope="module")
def tiny():
    jmodel, jparams, _ = tiny_model()
    jparams = _outlier_embed(jparams, None)
    state = port_state(jparams)
    return jmodel, jparams, state, pq.Qwen3VLModel.from_params(port_config(), state)


def test_stats_equal_jax(tiny):
    jmodel, jparams, _, model = tiny
    rng = np.random.RandomState(0)
    batches = [rng.randint(2, 200, (2, 16)) for _ in range(2)]
    want = jax_awq.collect_awq_stats(jmodel, jparams, batches)
    got = awq.collect_awq_stats(model, batches)
    assert set(got) == set(want) == {"layer_0", "layer_1"}
    for layer in want:
        for site in ("qkv", "o", "gu", "down"):
            for g, w in zip(got[layer][site], want[layer][site]):
                np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5, err_msg=f"{layer} {site}")


def test_scales_pick_jax_alphas(tiny):
    jmodel, jparams, state, model = tiny
    rng = np.random.RandomState(2)
    calib = rng.randint(2, 200, (4, 32))
    t = port_config().text
    stats = jax_awq.collect_awq_stats(jmodel, jparams, calib)
    want = jax_awq.compute_awq_scales(jparams["language_model"], stats, t.num_heads,
                                      t.num_kv_heads, t.head_dim)
    text = params_to_jax(state)["language_model"]
    got = awq.compute_awq_scales(text, stats, t.num_heads, t.num_kv_heads, t.head_dim)
    picked = []
    for layer, w in want.items():
        assert got[layer]["alpha"] == w["alpha"], layer
        picked += [a for a in w["alpha"].values()]
        for site in ("qkv", "o", "gu", "down"):
            np.testing.assert_allclose(got[layer][site], w[site], rtol=1e-6)
            for kind in ("awq", "rtn"):
                np.testing.assert_allclose(got[layer]["err"][site][kind],
                                           w["err"][site][kind], rtol=1e-4)
    assert any(a > 0 for a in picked)       # the fixture's outliers move the search


def test_fold_is_output_preserving(tiny):
    _, jparams, state, _ = tiny
    t = port_config().text
    ids = np.random.RandomState(1).randint(2, 200, (2, 12))
    ref = port_logits(state, ids)
    groups_q = t.num_heads // t.num_kv_heads
    scales = {}
    for li in range(t.num_layers):
        r = np.random.RandomState(10 + li)
        scales[f"layer_{li}"] = {
            "qkv": np.exp(r.randn(t.hidden_size) * 0.5).astype(np.float32),
            "o": np.repeat(np.exp(r.randn(t.num_kv_heads, 1, t.head_dim) * 0.5), groups_q,
                           axis=1).reshape(-1).astype(np.float32),
            "gu": np.exp(r.randn(t.hidden_size) * 0.5).astype(np.float32),
            "down": np.exp(r.randn(t.intermediate_size) * 0.5).astype(np.float32)}
    tree = params_to_jax(state)
    tree["language_model"] = awq.fold_awq_scales(tree["language_model"], scales,
                                                 t.num_kv_heads, t.head_dim)
    np.testing.assert_allclose(port_logits(params_from_jax(tree), ids), ref,
                               rtol=2e-4, atol=2e-4)
    # and the fold itself equals JAX's, bit for bit
    want = jax_awq.fold_awq_scales(dict(jparams["language_model"]), scales,
                                   t.num_kv_heads, t.head_dim)
    for layer in scales:
        for name, entry in want[layer].items():
            for leaf, value in (entry.items() if isinstance(entry, dict) else
                                [(None, entry)]):
                got = tree["language_model"][layer][name]
                got = got[leaf] if leaf else got
                np.testing.assert_array_equal(got.numpy(), np.asarray(value),
                                              err_msg=f"{layer} {name} {leaf}")


def test_pipeline_equals_jax_and_beats_rtn(tiny):
    jmodel, jparams, state, model = tiny
    rng = np.random.RandomState(2)
    calib = rng.randint(2, 200, (4, 32))
    evalids = rng.randint(2, 200, (2, 24))
    want, want_report = jax_awq.awq_quantize_qwen_text_params(jmodel, jparams, calib,
                                                              return_report=True)
    got, report = awq.awq_quantize_qwen_text_params(model, params_to_jax(state), calib,
                                                    return_report=True)
    assert {ln: e["alpha"] for ln, e in report.items()} == \
        {ln: e["alpha"] for ln, e in want_report.items()}
    differing = 0
    for layer in ("layer_0", "layer_1"):
        for proj in ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj",
                     "down_proj"):
            g, w = got["language_model"][layer][proj], want["language_model"][layer][proj]
            assert set(g) == set(w) == {"kernel_p4", "kernel_scale4"}
            differing += int((g["kernel_p4"].numpy() != np.asarray(w["kernel_p4"])).sum())
            np.testing.assert_allclose(g["kernel_scale4"].numpy(),
                                       np.asarray(w["kernel_scale4"]), rtol=1e-6)
        for norm in ("input_ln", "post_ln"):
            np.testing.assert_allclose(got["language_model"][layer][norm]["scale"].numpy(),
                                       np.asarray(want["language_model"][layer][norm]["scale"]),
                                       rtol=1e-6)
    assert differing == 0
    for layer in report.values():
        for site in ("qkv", "o", "gu", "down"):
            assert layer["err"][site]["awq"] <= layer["err"][site]["rtn"] + 1e-9

    ref = _forward_logits(jmodel, jparams, jnp.asarray(evalids))
    tree = params_to_jax(state)
    tree["language_model"] = quantize_qwen_text_params(tree["language_model"],
                                                       precision="int4")

    def cos(a, b):
        a, b = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
        return float(np.mean((a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                                                 * np.linalg.norm(b, axis=-1) + 1e-12)))

    c_rtn = cos(port_logits(params_from_jax(tree), evalids), ref)
    c_awq = cos(port_logits(params_from_jax(got), evalids), ref)
    assert c_awq >= c_rtn - 1e-4 and c_awq > 0.97, (c_awq, c_rtn)
    # the JAX pipeline's own RTN tree gives the port's RTN cosine
    jtree = {**jparams, "language_model": jax_quantize(dict(jparams["language_model"]),
                                                       precision="int4")}
    assert cos(_forward_logits(jmodel, jtree, jnp.asarray(evalids)), ref) == \
        pytest.approx(c_rtn, abs=1e-5)


def test_awq_depth_tool_on_outlier_fixture():
    """``tools/awq_depth`` (chip_smoke's AWQ gate): its outlier fixture is
    JAX's ``_outlier_embed`` bit for bit, its fold alone keeps the f32
    logits, and on the fixture int4_awq's cosine to the f32 logits is at
    least RTN's less 1e-4, as JAX's pipeline test holds."""
    from emr2a_tpu_torch.tools import awq_depth
    _, jparams, _ = tiny_model()
    state = port_state(jparams)
    loud = awq_depth.outlier_state(state)
    name = "language_model.embed_tokens.embedding"
    np.testing.assert_array_equal(loud[name].numpy(),
                                  port_state(_outlier_embed(jparams, None))[name].numpy())
    got = awq_depth.awq_cosines(port_config(), loud, 2, None, fold_only=True)
    assert got["alpha_pos"] and got["fold_only"]["mean"] > 1 - 1e-5, got
    assert got["int4_awq"]["mean"] >= got["int4"]["mean"] - 1e-4, got
