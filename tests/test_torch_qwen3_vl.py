"""The port's Qwen3-VL against the JAX package on the tiny random-init HF
Qwen3-VL of ``tests/test_qwen3_vl_parity.py``, loaded into both packages from
one state dict (f32 on the CPU, so every kernel takes its plain version):

- the vision tower and its deepstack features: one image, three uniform
  images (the frame-batched layout that K8 serves on the card) and a mixed
  layout, within 2e-5 of JAX (JAX's own bar against HF is 5e-4);
- the full multimodal forward's logits within 1e-4;
- greedy generation: identical tokens to JAX's (and HF's), invariant to the
  prompt bucket, ``chunk=`` equal to the one-shot loop, and identical
  tokens with the int8 (K5) and int4 (K7) decoders of
  ``quantize_qwen_text_params``; the continuous batcher's rows equal
  JAX's, with and without a draft; speculative acceptance and int4_awq
  against JAX; tensor parallelism, still unported, raises;
- ``params_from_jax`` / ``params_to_jax`` round trip, the JAX package's host
  helpers (M-RoPE positions, vision groups, gather indices) equal;
- checkpoints: the port's own safetensors reader equals the ``safetensors``
  package on ``save_pretrained`` directories, sharded and unsharded, and
  ``load_qwen3_vl`` reads one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import emr2a_tpu.models.qwen3_vl as jq
from emr2a_tpu.models.quantize import (
    quantize_qwen_text_params as jax_quantize_qwen_text_params,
)
from emr2a_tpu_torch.models import qwen3_vl as pq
from emr2a_tpu_torch.parallel import force_cpu_devices
from emr2a_tpu_torch.parallel import mesh as port_mesh
from emr2a_tpu_torch.models.convert import (
    load_state_dict,
    params_from_jax,
    params_to_jax,
    read_safetensors,
)

torch.set_num_threads(1)
transformers = pytest.importorskip("transformers")


def tiny_hf_model():
    from transformers import Qwen3VLConfig as HFConfig
    from transformers import Qwen3VLForConditionalGeneration
    cfg = HFConfig(
        vision_config=dict(
            depth=3, hidden_size=32, intermediate_size=64, num_heads=2,
            patch_size=4, temporal_patch_size=2, spatial_merge_size=2,
            out_hidden_size=48, num_position_embeddings=64,
            deepstack_visual_indexes=[0, 1], in_channels=3),
        text_config=dict(
            vocab_size=200, hidden_size=48, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, head_dim=12,
            intermediate_size=96, rope_theta=10000.0,
            rope_scaling={"rope_type": "default", "mrope_section": [2, 2, 2]},
            max_position_embeddings=512),
        image_token_id=190, video_token_id=191, vision_start_token_id=192,
        tie_word_embeddings=True,
        attn_implementation="eager")
    torch.manual_seed(0)
    return Qwen3VLForConditionalGeneration(cfg).eval(), cfg


@pytest.fixture(scope="module")
def tiny():
    """(hf model, hf config, JAX config, JAX params, port config, port
    state), the two packages' params converted from one state dict."""
    model, cfg = tiny_hf_model()
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    jparams = jq.convert_hf_qwen3_vl(sd, vision_depth=3, text_layers=2)
    jcfg = jq.qwen3_vl_config_from_hf(cfg.to_dict())
    pcfg = pq.qwen3_vl_config_from_hf(cfg.to_dict())
    state = params_from_jax(pq.convert_hf_qwen3_vl(sd, vision_depth=3, text_layers=2))
    return model, cfg, jcfg, jparams, pcfg, state


def make_pixels(rng, h=16, w=16):
    from emr2a_tpu_torch.encoders.qwen3_vl_encoder import QwenImageProcessor
    proc = QwenImageProcessor(patch_size=4, temporal_patch_size=2, merge_size=2,
                              min_pixels=16, max_pixels=16384)
    out = proc(images=[(rng.rand(h, w, 3) * 255).astype(np.uint8)])
    return out["pixel_values"], out["image_grid_thw"]


def _grid(grid):
    return tuple(tuple(int(x) for x in g) for g in grid)


@pytest.mark.parametrize("sizes", [((16, 16),), ((16, 16),) * 3, ((16, 16), (24, 16))])
def test_vision_tower_and_deepstack_match_jax(tiny, rng, sizes):
    _, _, jcfg, jparams, pcfg, state = tiny
    parts = [make_pixels(rng, h, w) for h, w in sizes]
    pixels = np.concatenate([p for p, _ in parts])
    grid = _grid(np.concatenate([g for _, g in parts]))
    want, want_ds, _ = jq.QwenVisionTower(jcfg.vision).apply(
        {"params": jparams["visual"]}, jnp.asarray(pixels), grid)
    model = pq.Qwen3VLModel.from_params(pcfg, state)
    got, got_ds, _ = model.visual(torch.from_numpy(pixels), grid)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-4)
    assert len(got_ds) == len(want_ds) == 2
    for g, w in zip(got_ds, want_ds):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5, rtol=1e-4)


def _mm_ids(grid, tail, n_images=1):
    per = int(np.prod(grid[0])) // 4
    return np.asarray([[5, 6] + ([192] + [190] * per) * n_images + list(tail)], np.int64)


def test_full_forward_with_image_matches_jax(tiny, rng):
    _, _, jcfg, jparams, pcfg, state = tiny
    pixels, grid = make_pixels(rng)
    grid = _grid(grid)
    ids = _mm_ids(grid, [5, 6, 7, 8])
    pos = jq.compute_mrope_position_ids(ids, grid, jcfg.image_token_id)
    np.testing.assert_array_equal(
        pq.compute_mrope_position_ids(ids, grid, pcfg.image_token_id), pos)
    want, _ = jq.Qwen3VLModel(jcfg).apply({"params": jparams}, jnp.asarray(ids),
                                          jnp.asarray(pos),
                                          pixel_patches=jnp.asarray(pixels), grid_thw=grid)
    model = pq.Qwen3VLModel.from_params(pcfg, state)
    got, _ = model(torch.from_numpy(ids), torch.from_numpy(pos),
                   pixel_patches=torch.from_numpy(pixels), grid_thw=grid)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_greedy_generation_matches_jax_and_hf(tiny, rng):
    """Three uniform images (the K8 layout), bucketing and chunked early
    exit: identical tokens to the JAX generator and to HF's generate."""
    hf, _, jcfg, jparams, pcfg, state = tiny
    parts = [make_pixels(rng) for _ in range(3)]
    pixels = np.concatenate([p for p, _ in parts])
    grid = _grid(np.concatenate([g for _, g in parts]))
    ids = _mm_ids(grid, [9], n_images=3)
    want = np.asarray(jq.Qwen3VLGenerator(jq.Qwen3VLModel(jcfg), jparams, eos_token_id=-1)
                      .generate(ids, pixel_patches=pixels, grid_thw=grid,
                                max_new_tokens=6, prompt_bucket=64))
    with torch.no_grad():
        hf_out = hf.generate(input_ids=torch.from_numpy(ids),
                             pixel_values=torch.from_numpy(pixels),
                             image_grid_thw=torch.tensor(grid), max_new_tokens=6,
                             do_sample=False)
    np.testing.assert_array_equal(want[0], hf_out[0, ids.shape[1]:].numpy())
    gen = pq.Qwen3VLGenerator(pq.Qwen3VLModel.from_params(pcfg, state), eos_token_id=-1)
    for kw in (dict(prompt_bucket=64), dict(prompt_bucket=16), dict(prompt_bucket=64, chunk=4)):
        got = gen.generate(ids, pixel_patches=pixels, grid_thw=grid, max_new_tokens=6, **kw)
        np.testing.assert_array_equal(got, want, err_msg=str(kw))


def test_chunked_decode_stops_early_with_eos(tiny):
    """chunk=K checks every K steps whether every row has stopped: with an
    eos the model emits, the loop breaks and pads with eos, exactly as the
    one-shot loop's tokens."""
    _, _, _, _, pcfg, state = tiny
    model = pq.Qwen3VLModel.from_params(pcfg, state)
    ids = np.array([[3, 5, 8, 13, 21, 34, 55, 89, 144, 6, 7],
                    [7, 2, 9, 31, 4, 16, 25, 36, 49, 64, 81]], np.int64)
    stream = pq.Qwen3VLGenerator(model, eos_token_id=-1).generate(
        ids, max_new_tokens=10, prompt_bucket=16)
    eos = int(stream[0, 2])
    gen = pq.Qwen3VLGenerator(model, eos_token_id=eos)
    a = gen.generate(ids, max_new_tokens=10, prompt_bucket=16)
    b = gen.generate(ids, max_new_tokens=10, prompt_bucket=16, chunk=3)
    np.testing.assert_array_equal(a, b)
    assert (a[0, 3:] == eos).all()


@pytest.mark.parametrize("precision", ["int8", "int4"])
def test_quantized_decoder_tokens_equal_jax(tiny, rng, precision):
    """The int8 (K5) and int4 (K7) decoders, quantized by each package from
    the same f32 weights: byte-identical trees and identical greedy tokens."""
    _, _, jcfg, jparams, pcfg, state = tiny
    jtree = {**jparams, "language_model": jax_quantize_qwen_text_params(
        jparams["language_model"], precision=precision)}
    from emr2a_tpu_torch.judge.qwen_backend import quantize_decoder
    qstate = quantize_decoder(state, precision)
    want_state = params_from_jax(jtree)
    assert set(qstate) == set(want_state)
    for k, v in want_state.items():
        assert torch.equal(qstate[k], v), k
    pixels, grid = make_pixels(rng)
    grid = _grid(grid)
    ids = _mm_ids(grid, [5, 6, 7])
    want = jq.Qwen3VLGenerator(jq.Qwen3VLModel(jcfg), jtree, eos_token_id=-1).generate(
        ids, pixel_patches=pixels, grid_thw=grid, max_new_tokens=5, prompt_bucket=32)
    model = pq.Qwen3VLModel.from_params(pcfg, qstate)
    kind = {"int8": pq.Int8Dense, "int4": pq.Int4Dense}[precision]
    assert isinstance(model.language_model.layers[0].down_proj, kind)
    got = pq.Qwen3VLGenerator(model, eos_token_id=-1).generate(
        ids, pixel_patches=pixels, grid_thw=grid, max_new_tokens=5, prompt_bucket=32)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_fused_projections_equal_unfused(tiny):
    """``fuse_projs`` builds qkv_proj / gate_up_proj; the logits equal the
    unfused int4 decoder's (per-column scales: the same codes)."""
    from emr2a_tpu_torch.models.quantize import quantize_qwen_text_params
    _, _, _, _, pcfg, state = tiny
    tree = params_to_jax(state)
    outs = []
    for fuse in (False, True):
        lm = quantize_qwen_text_params(tree["language_model"], precision="int4",
                                       fuse_projs=fuse)
        model = pq.Qwen3VLModel.from_params(pcfg, params_from_jax({**tree,
                                                                   "language_model": lm}))
        assert model.language_model.layers[0].fused_qkv == fuse
        ids = torch.tensor([[3, 5, 8, 13, 21]])
        pos = torch.from_numpy(pq.compute_mrope_position_ids(ids.numpy(), [], 190))
        outs.append(model(ids, pos)[0])
    torch.testing.assert_close(outs[0], outs[1], atol=1e-5, rtol=1e-5)


def test_params_round_trip_and_host_helpers(tiny):
    _, _, jcfg, jparams, pcfg, state = tiny
    again = params_from_jax(params_to_jax(state))
    assert set(again) == set(state) and all(torch.equal(again[k], state[k]) for k in state)
    # the JAX package's own tree carries across to the same state dict
    from_jax = params_from_jax(jparams)
    assert set(from_jax) == set(state) and all(torch.equal(from_jax[k], state[k])
                                               for k in state)
    assert "language_model.layers.1.q_norm_scale" in state
    assert "visual.deepstack_mergers.1.norm.weight" in state
    grids = ((1, 4, 4),) * 4
    assert pq.plan_vision_groups(pcfg.vision, grids) == jq.plan_vision_groups(
        jcfg.vision, grids)
    assert pq.plan_vision_groups(pcfg.vision, grids, budget=1) == jq.plan_vision_groups(
        jcfg.vision, grids, budget=1)
    assert pq.plan_vision_groups(pcfg.vision, ((2, 4, 4), (1, 4, 4)), budget=1) is None
    mask = np.array([[0, 1, 1, 0, 1], [1, 0, 0, 1, 1]], bool)
    np.testing.assert_array_equal(
        pq.visual_gather_indices(torch.from_numpy(mask), 6).numpy(),
        np.asarray(jq.visual_gather_indices(jnp.asarray(mask), 6)))


def test_vision_groups_are_exact(tiny, rng, monkeypatch):
    """A forced one-image budget splits the tower per image; the logits are
    the one-shot forward's up to f32 summation order (the CPU's matmul
    blocks a 3-image product otherwise than a 1-image one)."""
    _, _, _, _, pcfg, state = tiny
    model = pq.Qwen3VLModel.from_params(pcfg, state)
    parts = [make_pixels(rng) for _ in range(3)]
    pixels = torch.from_numpy(np.concatenate([p for p, _ in parts]))
    grid = _grid(np.concatenate([g for _, g in parts]))
    ids = torch.from_numpy(_mm_ids(grid, [9], n_images=3))
    pos = torch.from_numpy(pq.compute_mrope_position_ids(ids.numpy(), grid, 190))
    one_shot = model(ids, pos, pixel_patches=pixels, grid_thw=grid)[0]
    monkeypatch.setattr(pq, "_VISION_TEMP_BUDGET", 1)
    assert len(pq.plan_vision_groups(pcfg.vision, grid)) == 3
    grouped = model(ids, pos, pixel_patches=pixels, grid_thw=grid)[0]
    torch.testing.assert_close(grouped, one_shot, atol=1e-6, rtol=1e-5)


def test_not_ported_options_raise(tiny):
    """Tensor parallelism is ported (``tests/test_torch_tp.py``,
    ``tests/test_torch_serving_tp.py``): a ``mesh`` that is not a
    ``parallel.Mesh`` raises ``TypeError`` in the generator and the batcher,
    and ``QwenVLBackend(tp=2)`` over the 8 CPU devices builds JAX's (4, 2)
    mesh and a sharded model. Speculative decoding
    and AWQ are ported and held against JAX here on the HF-converted
    weights: ``spec_accept`` on point-mass rows, ``quantize_decoder(...,
    "int4_awq")``'s codes, a self-drafting backend's text and the batcher
    with a draft (further in ``tests/test_torch_speculative.py``,
    ``tests/test_torch_spec_serving.py`` and ``tests/test_torch_awq.py``).
    Batched and continuous serving are ported: the batcher's rows equal JAX's
    ``ContinuousBatcher``'s here (and in ``tests/test_torch_serving.py``).
    (The int8 KV cache, chunked prefill, per-row offsets and sampling are held
    against JAX in ``tests/test_torch_qwen3_vl_options.py``.)"""
    from emr2a_tpu.judge.qwen_backend import _quantize_decoder as jax_quantize_decoder
    from emr2a_tpu.models.serving import ContinuousBatcher as JaxBatcher
    from emr2a_tpu_torch.judge.qwen_backend import QwenVLBackend, quantize_decoder
    from emr2a_tpu_torch.models.serving import ContinuousBatcher
    _, _, jcfg, jparams, pcfg, state = tiny
    model = pq.Qwen3VLModel.from_params(pcfg, state)
    with pytest.raises(TypeError, match="parallel.Mesh"):
        pq.Qwen3VLGenerator(model, mesh=object())
    saved = port_mesh._default_mesh
    try:
        force_cpu_devices(8)
        tp_backend = QwenVLBackend(config=pcfg, params=state, tp=2)
    finally:
        port_mesh.set_default_mesh(saved)
    assert tp_backend.mesh.shape == {"data": 4, "model": 2}
    assert isinstance(tp_backend.model, pq.ShardedQwen3VLModel)
    assert tp_backend.generator.mesh is tp_backend.mesh
    with pytest.raises(TypeError, match="parallel.Mesh"):
        ContinuousBatcher(model, mesh=object())
    # spec_accept: point masses reduce to the prefix match, as JAX's does
    rng = np.random.RandomState(0)
    t_logits, d_logits = rng.randn(4, 200).astype(np.float32), rng.randn(3, 200).astype(np.float32)
    d_logits[:2] = t_logits[:2]
    lp = lambda x: jq.filtered_log_probs(jnp.asarray(x), jnp.zeros(len(x)), jnp.ones(len(x)))
    drafts = d_logits.argmax(-1)[None]
    want = jq.spec_accept(jnp.asarray(drafts), lp(d_logits)[None], lp(t_logits)[None],
                          jnp.zeros((1, 2), jnp.uint32))
    plp = lambda x: pq.filtered_log_probs(torch.from_numpy(x), torch.zeros(len(x)),
                                          torch.ones(len(x)))
    got = pq.spec_accept(torch.from_numpy(drafts), plp(d_logits)[None], plp(t_logits)[None],
                         pq.stream_keys(torch.tensor([0]), 0))
    assert int(got[1][0]) == int(want[1][0]) == 2
    np.testing.assert_array_equal(got[0][0, :3].numpy(), np.asarray(want[0][0, :3]))
    # int4_awq needs its model, then quantizes as JAX does
    with pytest.raises(ValueError, match="calibration"):
        quantize_decoder(state, "int4_awq")
    class CharTokenizer:            # ids inside the tiny vocabulary
        eos_token_id = 199

        def __call__(self, text, add_special_tokens=False, **kw):
            return {"input_ids": [2 + ord(c) % 180 for c in text]}

        def decode(self, ids, skip_special_tokens=True):
            return " ".join(map(str, ids))

    tok = CharTokenizer()
    got = params_to_jax(quantize_decoder(state, "int4_awq", model=model, tokenizer=tok))
    want = jax_quantize_decoder(jparams, "int4_awq", model=jq.Qwen3VLModel(jcfg),
                                tokenizer=tok)
    for proj in ("q_proj", "o_proj", "down_proj"):
        g = got["language_model"]["layer_1"][proj]["kernel_p4"].numpy()
        assert (g == np.asarray(want["language_model"]["layer_1"][proj]["kernel_p4"])).mean() > 0.99
    # a self-drafting backend says what the plain one says
    plain = QwenVLBackend(config=pcfg, params=state, tokenizer=tok, prompt_bucket=16)
    spec = QwenVLBackend(config=pcfg, params=state, tokenizer=tok, prompt_bucket=16,
                         draft_config=pcfg, draft_params=state, spec_k=2)
    assert spec.spec_generator is not None and plain.spec_generator is None
    assert spec.generate([], "describe", max_new_tokens=6) == \
        plain.generate([], "describe", max_new_tokens=6)
    reqs = [{"input_ids": np.array([[5, 6, 7, 8, 9, 10][:n]], np.int64)} for n in (3, 6, 4)]
    kw = dict(n_slots=2, prompt_bucket=8, max_new_tokens=5, eos_token_id=-1, chunk=2)
    jmodel = jq.Qwen3VLModel(jcfg)
    want = JaxBatcher(jmodel, jparams, **kw).serve(reqs)
    for got, w in zip(ContinuousBatcher(model, **kw).serve(reqs), want):
        np.testing.assert_array_equal(got, np.asarray(w))
    want = JaxBatcher(jmodel, jparams, draft_model=jmodel, draft_params=jparams, spec_k=2,
                      **kw).serve(reqs)
    for got, w in zip(ContinuousBatcher(model, draft_model=model, spec_k=2, **kw).serve(reqs),
                      want):
        np.testing.assert_array_equal(got, np.asarray(w))


@pytest.mark.parametrize("shard", [None, "20KB"])
def test_safetensors_reader_equals_safetensors(tiny, tmp_path, shard):
    """The port's reader on an HF ``save_pretrained`` directory, sharded or
    not, in f32 and in bf16, against the ``safetensors`` package; then
    ``load_qwen3_vl`` reads the directory into the same state dict as the
    converter."""
    import copy

    from safetensors.torch import load_file

    from emr2a_tpu_torch.models.checkpoint import load_qwen3_vl
    hf, cfg, _, _, pcfg, state = tiny
    for dtype in (torch.float32, torch.bfloat16):
        out = tmp_path / str(dtype)
        kw = {} if shard is None else {"max_shard_size": shard}
        copy.deepcopy(hf).to(dtype).save_pretrained(out, safe_serialization=True, **kw)
        files = sorted(out.glob("*.safetensors"))
        assert (len(files) > 1) == (shard is not None)
        for f in files:
            want = load_file(str(f))
            got = read_safetensors(f)
            assert set(got) == set(want)
            for k, v in want.items():
                assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
        sd = load_state_dict(out)
        assert set(sd) == {k for f in files for k in load_file(str(f))}
        config, loaded = load_qwen3_vl(out, dtype=torch.float32)
        assert config.text.num_layers == 2 and config.vision.depth == 3
        want_state = {k: v.to(dtype).float() for k, v in state.items()}
        assert set(loaded) == set(want_state)
        for k, v in want_state.items():
            assert torch.equal(loaded[k], v), k
