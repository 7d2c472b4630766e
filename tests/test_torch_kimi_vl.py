"""Kimi-VL-A3B (``models/kimi_vl.py``, ``judge/kimi_backend.py``, K11's
plain version in ``ops/moe.py``) against the plain reference
``tests/reference/kimi_vl.py`` on the CPU, at a small size with seeded
weights:

- the parameter names and shapes are the reference plan's;
- MoonViT and the projector, on one image and on two of different sizes
  (the position table interpolated; the mixed layout's masked attention);
- the prefill's logits (the expanded MLA) against the reference's forward;
- a prefill into the latent cache, then decode steps through the absorbed
  form, against the reference's forward over the whole sequence;
- the expert layer against a loop over tokens and their chosen experts,
  with a correction bias that changes the choice and one that sends every
  token to one expert;
- ``generate`` at B = 1 and ``generate_stream`` over 4 slots with mixed
  budgets and refills (the batcher's and the generator's shared path)
  against the reference's greedy tokens;
- a planted fault (the routing scale 1.0 in place of 2.446) that the
  comparison catches;
- the route records the batcher keeps for each request
  (``record_routes``) against a whole-sequence forward's choices;
- the reference's bf16 mode (the witness of what rounding moves).

Tolerances: both sides compute in float32 here, so the logits agree to
float32 rounding of differently ordered sums (the program's latent cache
and absorbed products, the reference's expanded heads): 2e-4 of the
logits' scale (about 1) holds them with room, while the planted fault
moves them by more than 0.05.
"""

import importlib.util
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch

from emr2a_tpu_torch.judge.kimi_backend import KimiVLBackend, kimi_patches
from emr2a_tpu_torch.models import kimi_vl as kv
from emr2a_tpu_torch.models.qwen3_vl import Qwen3VLGenerator, QwenVisionConfig
from emr2a_tpu_torch.tools.stub_tokenizer import KimiWordTokenizer

REPO = Path(__file__).resolve().parents[1]
spec = importlib.util.spec_from_file_location("kimi_reference",
                                              REPO / "tests" / "reference" / "kimi_vl.py")
ref = importlib.util.module_from_spec(spec)
spec.loader.exec_module(ref)

TOL = 2e-4
IMG = 163605
CFG = {"vision_config": {"patch_size": 14, "init_pos_emb_height": 4, "init_pos_emb_width": 4,
                         "num_attention_heads": 2, "num_hidden_layers": 2, "hidden_size": 32,
                         "intermediate_size": 64, "merge_kernel_size": [2, 2]},
       "vocab_size": 163840, "hidden_size": 64, "num_hidden_layers": 3,
       "num_attention_heads": 4, "kv_lora_rank": 32, "qk_nope_head_dim": 16,
       "qk_rope_head_dim": 8, "v_head_dim": 16, "intermediate_size": 96,
       "moe_intermediate_size": 32, "n_routed_experts": 8, "n_shared_experts": 2,
       "num_experts_per_tok": 3, "first_k_dense_replace": 1, "routed_scaling_factor": 2.446,
       "rms_norm_eps": 1e-5, "rope_theta": 800000, "image_token_id": IMG}


def program_config(c: dict = CFG, dtype=torch.float32) -> kv.KimiVLConfig:
    v = c["vision_config"]
    vision = QwenVisionConfig(
        depth=v["num_hidden_layers"], hidden_size=v["hidden_size"],
        intermediate_size=v["intermediate_size"], num_heads=v["num_attention_heads"],
        in_channels=3, patch_size=v["patch_size"], temporal_patch_size=1,
        spatial_merge_size=v["merge_kernel_size"][0], out_hidden_size=c["hidden_size"],
        num_position_embeddings=v["init_pos_emb_height"] * v["init_pos_emb_width"],
        deepstack_visual_indexes=(), dtype=dtype, layer_norm_eps=1e-5, rope_pairs=True)
    text = kv.KimiTextConfig(
        vocab_size=c["vocab_size"], hidden_size=c["hidden_size"],
        num_layers=c["num_hidden_layers"], num_heads=c["num_attention_heads"],
        kv_lora_rank=c["kv_lora_rank"], qk_nope_head_dim=c["qk_nope_head_dim"],
        qk_rope_head_dim=c["qk_rope_head_dim"], v_head_dim=c["v_head_dim"],
        intermediate_size=c["intermediate_size"],
        moe_intermediate_size=c["moe_intermediate_size"],
        n_routed_experts=c["n_routed_experts"], n_shared_experts=c["n_shared_experts"],
        num_experts_per_tok=c["num_experts_per_tok"],
        first_k_dense_replace=c["first_k_dense_replace"],
        routed_scaling_factor=c["routed_scaling_factor"], rms_norm_eps=c["rms_norm_eps"],
        rope_theta=float(c["rope_theta"]), dtype=dtype)
    return kv.KimiVLConfig(vision=vision, text=text, image_token_id=c["image_token_id"])


def draw(seed: int = 0) -> dict:
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, shape, init in ref.weight_plan(CFG):
        x = torch.randn(shape, generator=g) * init[1]
        out[name] = x + 1 if init[0] == "around_one" else x
    return out


@pytest.fixture(scope="module")
def weights():
    return draw()


@pytest.fixture(scope="module")
def model(weights):
    return kv.KimiVLModel.from_params(program_config(), weights)


def images(sizes=((56, 84), (56, 84)), seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in sizes]


def prompt(imgs) -> list:
    """Text, each image's placeholders (h w / 4 / 196 of them), text."""
    ids = [5, 6, 7]
    for im in imgs:
        ids += [IMG] * (im.shape[0] // 28 * im.shape[1] // 28) + [11, 12]
    return ids + [13, 14, 15, 16]


def program_inputs(imgs):
    patches, grids = zip(*[kimi_patches(im) for im in imgs])
    return torch.from_numpy(np.concatenate(patches)), tuple(grids)


def close(a, b, tol=TOL):
    scale = b.abs().max().item()
    assert (a - b).abs().max().item() <= tol * max(scale, 1.0), \
        ((a - b).abs().max().item(), scale)


def test_names_and_shapes_are_the_plans():
    plan = {n: tuple(s) for n, s, _ in ref.weight_plan(CFG)}
    model = kv.KimiVLModel(program_config(), device="meta")
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == plan


def test_published_cache_and_positions():
    m = kv.KimiVLModel(kv.KimiVLConfig(text=kv.KimiTextConfig(dtype=torch.bfloat16)),
                       device="meta")
    # 576 bf16 values a token and layer over 27 layers: 31.1 KB a token
    assert m.cache_bytes_per_row(1, "bf16") == 576 * 2 * 27
    pos = m.position_ids(np.zeros((2, 5), np.int64), ())
    assert pos.shape == (1, 2, 5) and (pos[0, 1] == np.arange(5)).all()
    with pytest.raises(ValueError):
        m.empty_cache(1, 4, "int8")


@pytest.mark.parametrize("sizes", [((56, 56),), ((56, 84), (56, 84)), ((56, 84), (84, 56))])
def test_tower_and_projector(weights, model, sizes):
    imgs = images(sizes)
    patches, grids = program_inputs(imgs)
    with torch.no_grad():
        got = model.visual(patches, grids)
    w = {k: v.float() for k, v in weights.items()}
    want = torch.cat([ref.vision_tower(w.__getitem__,
                                       torch.from_numpy(ref.image_patches(im, CFG)[0]),
                                       ref.image_patches(im, CFG)[1], CFG) for im in imgs])
    close(got, want)


def test_prefill_logits(weights, model):
    imgs = images()
    ids = prompt(imgs)
    patches, grids = program_inputs(imgs)
    pos = torch.from_numpy(model.position_ids(np.asarray([ids]), grids))
    with torch.no_grad():
        got, _ = model(torch.tensor([ids]), pos, patches, grids)
    close(got[0], ref.full_logits(weights, [{"ids": ids, "images": imgs}], CFG, "cpu")[0])


def test_prefill_then_absorbed_decode(weights, model):
    """The prompt into the latent cache (expanded MLA), then one token a
    step (absorbed MLA, reading the cache as stored), against the
    reference's forward over the whole sequence."""
    imgs = images()
    ids = prompt(imgs)
    extra = [101, 202, 303, 404]
    seq = ids + extra
    want = ref.full_logits(weights, [{"ids": seq, "images": imgs}], CFG, "cpu")[0]
    patches, grids = program_inputs(imgs)
    P, L = len(ids), len(seq) + 3
    cache = model.empty_cache(1, L, "bf16")
    k = torch.arange(L)[None, None, :]
    with torch.no_grad():
        mask = torch.where(k <= torch.arange(P)[None, :, None], 0.0, float("-inf"))
        pos = torch.from_numpy(model.position_ids(np.asarray([ids]), grids))
        logits, cache = model(torch.tensor([ids]), pos, patches, grids, cache=cache,
                              cache_pos=0, attn_mask=mask)
        close(logits[0], want[:P])
        for j, t in enumerate(extra):
            p = P + j
            mask = torch.where(k <= p, 0.0, float("-inf")).float()
            logits, cache = model(torch.tensor([[t]]), torch.tensor([[[p]]]), cache=cache,
                                  cache_pos=torch.tensor(p), attn_mask=mask)
            close(logits[0, 0], want[p])


def per_token_loop(moe, x):
    """Each token over its chosen experts, one at a time, in f32."""
    cfg = moe.config
    Ie = cfg.moe_intermediate_size
    out = []
    for row in x.float():
        s = torch.sigmoid(row @ moe.router.float())
        chosen = torch.topk(s + moe.router_bias.float(), cfg.num_experts_per_tok).indices
        w = s[chosen] / s[chosen].sum() * cfg.routed_scaling_factor
        y = torch.zeros_like(row)
        for e, we in zip(chosen.tolist(), w):
            gu = row @ moe.experts_gate_up[e].float()
            y += we * ((torch.nn.functional.silu(gu[:Ie]) * gu[Ie:]) @ moe.experts_down[e].float())
        out.append(y)
    return torch.stack(out) + moe.shared(x.float())


@pytest.mark.parametrize("case", ["plain", "bias_changes_choice", "one_expert_everywhere"])
def test_expert_layer_against_per_token_loop(weights, case):
    model = kv.KimiVLModel.from_params(program_config(), {k: v.clone() for k, v in weights.items()})
    moe = model.language_model.layers[1].moe
    x = torch.randn(40, CFG["hidden_size"], generator=torch.Generator().manual_seed(3))
    before = kv.route(x, moe.router, moe.router_bias, 3, 2.446)[0]
    if case == "bias_changes_choice":
        moe.router_bias[5] += 0.3
        after = kv.route(x, moe.router, moe.router_bias, 3, 2.446)[0]
        changed = (before != after).any(dim=1)
        assert 0 < int(changed.sum()) < len(x)
    if case == "one_expert_everywhere":
        moe.router_bias[2] += 10.0
        assert (kv.route(x, moe.router, moe.router_bias, 3, 2.446)[0] == 2).any(dim=1).all()
    with torch.no_grad():
        out, ids = moe(x)
    assert torch.equal(ids, kv.route(x, moe.router, moe.router_bias, 3, 2.446)[0])
    close(out, per_token_loop(moe, x), 1e-5)


def backend(weights, **kw):
    return KimiVLBackend(config=program_config(), params=weights, tokenizer=KimiWordTokenizer(),
                         prompt_bucket=32, **kw)


def served_logits(weights, b, imgs, text, served):
    """The reference's logits that predict ``served`` after the backend's
    own prompt."""
    ids, _, _ = b._prepare(imgs, text, "Audit carefully.")
    return ref.teacher_forced_logits(weights, [{"ids": ids, "images": imgs,
                                                "served": list(served)}], CFG, "cpu")[0]


def greedy_matches(logits, served):
    """Each served token is the reference's argmax, or within rounding of
    its best logit (a near-tie)."""
    best = logits.max(dim=-1).values
    got = logits.gather(1, torch.as_tensor(served)[:, None])[:, 0]
    assert (best - got).max().item() <= TOL


def test_generate_b1(weights):
    b = backend(weights)
    imgs = images()
    text = b.generate(imgs, "Is the prediction supported?", system="Audit carefully.",
                      max_new_tokens=6)
    served = [int(w[1:]) for w in text.split()]
    assert len(served) == 6
    greedy_matches(served_logits(weights, b, imgs, "Is the prediction supported?", served),
                   served)


def test_generate_stream_mixed_budgets_and_refills(weights):
    b = backend(weights)
    requests = [{"images": images(seed=i), "prompt": f"Case {i} under audit.",
                 "system": "Audit carefully.", "max_new_tokens": n}
                for i, n in enumerate([3, 7, 2, 5, 6, 4])]
    texts = b.generate_stream(requests, max_new_tokens=8, n_slots=4)
    for r, text in zip(requests, texts):
        served = [int(w[1:]) for w in text.split()]
        assert len(served) == r["max_new_tokens"]
        greedy_matches(served_logits(weights, b, r["images"], r["prompt"], served), served)
        one = b.generate(r["images"], r["prompt"], system=r["system"],
                         max_new_tokens=r["max_new_tokens"])
        assert one == text


def test_planted_fault_is_caught(weights):
    """The routing scale 1.0 in place of the published 2.446: the same
    comparison as ``test_prefill_logits`` fails it."""
    imgs = images()
    ids = prompt(imgs)
    cfg = program_config()
    faulty = kv.KimiVLModel.from_params(
        replace(cfg, text=replace(cfg.text, routed_scaling_factor=1.0)), weights)
    patches, grids = program_inputs(imgs)
    pos = torch.from_numpy(faulty.position_ids(np.asarray([ids]), grids))
    with torch.no_grad():
        got, _ = faulty(torch.tensor([ids]), pos, patches, grids)
    want = ref.full_logits(weights, [{"ids": ids, "images": imgs}], CFG, "cpu")[0]
    assert (got[0] - want).abs().max().item() > 0.05
    with pytest.raises(AssertionError):
        close(got[0], want)


def test_bf16_generator_runs_the_latent_cache(weights):
    """The working dtype of the card (bf16 weights, bf16 latent cache) on
    the CPU: a greedy generation whose logits stay within bf16's reach of
    the f32 reference's."""
    m = kv.KimiVLModel.from_params(program_config(dtype=torch.bfloat16),
                                   {k: v.to(torch.bfloat16) for k, v in weights.items()})
    imgs = images()
    ids = prompt(imgs)
    patches, grids = program_inputs(imgs)
    gen = Qwen3VLGenerator(m, eos_token_id=-1)
    toks = gen.generate(np.asarray([ids]), patches, grids, max_new_tokens=4, prompt_bucket=16)
    want = ref.teacher_forced_logits({k: v.to(torch.bfloat16) for k, v in weights.items()},
                                     [{"ids": ids, "images": imgs, "served": list(toks[0])}],
                                     CFG, "cpu")[0]
    gaps = want.max(dim=-1).values - want.gather(1, torch.as_tensor(toks[0])[:, None])[:, 0]
    # bf16 rounding of activations moves these logits (scale about 1) by
    # a few hundredths at most
    assert gaps.max().item() <= 0.1
    assert m.empty_cache(1, 8, "bf16")[0][0].dtype == torch.bfloat16


def test_stream_keeps_each_requests_routes(weights):
    """With ``record_routes`` the batcher keeps, as each request retires,
    its slot's route records: the prompt's positions at their own rows, the
    decoded tokens' in the ring past the bucket, each with the experts a
    whole-sequence forward of the program chooses there (f32 here, so the
    two forms choose alike)."""
    b = backend(weights, record_routes=True)
    requests = [{"images": images(seed=i), "prompt": f"Case {i} under audit.",
                 "system": "Audit carefully.", "max_new_tokens": n}
                for i, n in enumerate([3, 7, 2, 5, 6, 4])]
    texts = b.generate_stream(requests, max_new_tokens=8, n_slots=4)
    (batcher,) = b._batchers.values()
    assert sorted(batcher.records) == list(range(len(requests)))
    model, top_k = b.model, CFG["num_experts_per_tok"]
    seen = []
    route = kv.route

    def recording(x, *args):
        ids, w = route(x, *args)
        seen.append(ids)
        return ids, w

    for i, (r, text) in enumerate(zip(requests, texts)):
        served = [int(w[1:]) for w in text.split()]
        ids, patches, grids = b._prepare(r["images"], r["prompt"], r["system"])
        tl, seq = len(ids), list(ids) + served[:-1]
        rec = batcher.records[i]
        assert rec.shape == (CFG["num_hidden_layers"] - 1, batcher.max_len, 1 + top_k)
        assert torch.equal(rec[:, :tl, 0], torch.arange(1, tl + 1).expand(rec.shape[0], -1))
        ring = rec[:, batcher.prompt_bucket:]
        seen.clear()
        kv.route = recording
        try:
            with torch.no_grad():
                model(torch.tensor([seq]),
                      torch.from_numpy(model.position_ids(np.asarray([seq]), grids)),
                      torch.from_numpy(np.asarray(patches)), grids)
        finally:
            kv.route = route
        for layer, want in enumerate(seen):
            assert torch.equal(rec[layer, :tl, 1:], want[:tl])
            for g in range(len(served) - 1):
                hit = ring[layer, ring[layer, :, 0] == tl + g + 1]
                assert len(hit) == 1 and torch.equal(hit[0, 1:], want[tl + g])
        assert b.model.record_rows(batcher._state["cache"], 0).dtype == torch.int32


def test_without_records_the_cache_is_the_latent():
    m = kv.KimiVLModel(program_config(), device="meta")
    assert all(len(layer) == 1 for layer in m.empty_cache(2, 8, "bf16"))
    assert m.record_rows(m.empty_cache(2, 8, "bf16"), 0) is None
    r = kv.KimiVLModel(program_config(), device="meta", record_routes=True)
    assert [len(layer) for layer in r.empty_cache(2, 8, "bf16")] == [1, 2, 2]
    assert r.cache_bytes_per_row(8, "bf16") - m.cache_bytes_per_row(8, "bf16") == 8 * 2 * 4 * 4


def test_reference_in_bf16_is_the_witness_of_rounding(weights):
    """The reference run with bf16 weights and activations (the witness of
    what bf16 rounding alone moves) gives the same shapes and lies within
    bf16's reach of its own f32 logits here, where no routing ties."""
    imgs = images()
    req = [{"ids": prompt(imgs), "images": imgs, "served": [5, 6, 7]}]
    f32 = ref.teacher_forced_logits(weights, req, CFG, "cpu")[0]
    bf16 = ref.teacher_forced_logits(weights, req, CFG, "cpu", dtype=torch.bfloat16)[0]
    assert bf16.dtype == torch.float32 and bf16.shape == f32.shape
    # bf16 keeps about 3 significant digits: 2e-2 of the logits' scale
    assert (bf16 - f32).abs().max().item() <= 2e-2 * max(f32.abs().max().item(), 1.0)
