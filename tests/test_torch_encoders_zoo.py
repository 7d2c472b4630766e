"""The port's encoder zoo (``ViTEncoder``, ``CLIPEncoder``,
``Qwen3VLEncoder``, the factory) and K1/K2's quick_gelu on the CPU, against
the JAX package on the same inputs, with the weights carried across by
``models.convert.params_from_jax`` or converted by both packages from one
tiny random-init HF model.

Tolerances, the reference tests' own: f32 towers within atol 2e-4, rtol
1e-3 (``tests/test_model_parity.py``); ``fast`` (bf16) and ``fast="int8"``
embeddings within row cosine 0.999 (``tests/test_quantized_tower.py``);
the Qwen taps and text mean within atol 5e-4, rtol 1e-3
(``tests/test_qwen_encoder_backend.py``); K1/K2's plain versions as in
``tests/test_fused_mlp.py`` and ``tests/test_torch_act_dtype.py`` (f32
within 2e-5 / 1e-4; bf16 bit for bit on these inputs). The bf16 quick_gelu
equals XLA's bit for bit on 400,000 values.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emr2a_tpu.ops.mlp import fused_ln_mlp as jax_fused_ln_mlp
from emr2a_tpu.ops.mlp import fused_ln_mlp_int8 as jax_fused_ln_mlp_int8
from emr2a_tpu_torch.models.convert import params_from_jax
from emr2a_tpu_torch.ops import mlp

torch.set_num_threads(1)
transformers = pytest.importorskip("transformers")

ATOL, RTOL = 2e-4, 1e-3


def cosines(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def images(n=3, seed=5):
    r = np.random.RandomState(seed)
    sizes = [(224, 224), (300, 260), (256, 256), (240, 320)]
    return [(r.rand(*sizes[i % 4], 3) * 255).astype(np.uint8) for i in range(n)]


# -- K1 / K2 quick_gelu ------------------------------------------------------

def test_quick_gelu_bf16_equals_xla_bit_for_bit():
    x = (np.random.RandomState(3).randn(400_000) * 3).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    qg = lambda v: v * jax.nn.sigmoid(1.702 * v)
    want_bf16 = np.asarray(jax.jit(qg)(xb).astype(jnp.float32))
    want_f32 = np.asarray(jax.jit(lambda v: qg(v).astype(jnp.float32))(xb))
    got = mlp.quick_gelu_bf16(torch.from_numpy(x))
    np.testing.assert_array_equal(got.to(torch.bfloat16).float().numpy(), want_bf16)
    np.testing.assert_array_equal(got.numpy(), want_f32)


def _mlp_inputs(rng, T=300, d=64, m=256):
    # fc1 values of a few units, so that the activation's rounding matters
    return [v.astype(np.float32) for v in (
        rng.randn(T, d) * 0.5, rng.rand(d) + 0.5, rng.randn(d) * 0.1,
        rng.randn(d, m) * 0.3, rng.randn(m) * 0.1, rng.randn(m, d) * 0.05,
        rng.randn(d) * 0.01)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k1_quick_gelu_act_bf16_matches_jax(rng, dtype):
    a = _mlp_inputs(rng)
    want = jax_fused_ln_mlp(*(jnp.asarray(v, dtype) for v in a), tile=128,
                            activation="quick_gelu", act_dtype=jnp.bfloat16,
                            interpret=True)
    got = mlp.fused_ln_mlp(*(torch.from_numpy(v).to(getattr(torch, dtype)) for v in a),
                           activation="quick_gelu", act_dtype=torch.bfloat16)
    want = np.asarray(want, np.float32)
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got.float().numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, atol=2e-3, rtol=0)


_FLOAT = (0, 1, 2, 5, 8)     # x, LN and biases take the working dtype


@pytest.mark.parametrize("act", ["float32", "bfloat16"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k2_quick_gelu_matches_jax(rng, dtype, act):
    x, s, b, w1, b1, w2, b2 = _mlp_inputs(rng)
    (q1, s1), (q2, s2) = mlp.quantize_weight_int8(w1), mlp.quantize_weight_int8(w2)
    a = [x, s, b, q1, s1.reshape(-1), b1, q2, s2.reshape(-1), b2]
    want = jax_fused_ln_mlp_int8(
        *(jnp.asarray(v, dtype) if i in _FLOAT else jnp.asarray(v)
          for i, v in enumerate(a)), tile=128, activation="quick_gelu",
        act_dtype=getattr(jnp, act), interpret=True)
    got = mlp.fused_ln_mlp_int8(
        *(torch.from_numpy(v).to(getattr(torch, dtype)) if i in _FLOAT
          else torch.from_numpy(v) for i, v in enumerate(a)),
        activation="quick_gelu", act_dtype=getattr(torch, act))
    want = np.asarray(want, np.float32)
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got.float().numpy(), want)
    else:
        # a rare one-code flip where an f32 value lands on a rounding boundary
        err = np.abs(got.numpy() - want)
        assert err.max() <= 2e-2 and (err <= 1e-5).mean() >= 0.99


def test_cuda_activations_are_the_kernels():
    assert set(mlp.CUDA_ACTIVATIONS) == {"gelu", "quick_gelu"}


# -- ViTEncoder ----------------------------------------------------------------

def _vit_pair(fast, **over):
    from emr2a_tpu.encoders.vit_encoder import ViTEncoder as JaxViT
    from emr2a_tpu.models.vit import TIMM_VIT_B16 as JAX_TIMM
    from emr2a_tpu.models.vit import VisionTransformer as JaxTower
    from emr2a_tpu_torch.encoders.vit_encoder import ViTEncoder
    from emr2a_tpu_torch.models.vit import TIMM_VIT_B16

    small = dict(patch_size=32, hidden_size=128, num_layers=2, num_heads=2,
                 mlp_dim=256, **over)
    jcfg = dataclasses.replace(JAX_TIMM, **small)
    tree = jax.device_get(JaxTower(jcfg).init(
        jax.random.PRNGKey(1), jnp.zeros((1, jcfg.image_size, jcfg.image_size, 3)))["params"])
    jax_enc = JaxViT(config=jcfg, params=tree, device="cpu", fast=fast)
    port = ViTEncoder(config=dataclasses.replace(TIMM_VIT_B16, **small),
                      params=params_from_jax(tree), device="cpu", fast=fast)
    return jax_enc, port


@pytest.mark.parametrize("fast", [False, True, "int8"])
def test_vit_encoder_matches_jax(fast):
    jax_enc, port = _vit_pair(fast)
    imgs = images(3)
    want = np.stack([np.asarray(e, np.float32) for e in jax_enc.encode_batch_images(imgs)])
    got = np.stack(port.encode_batch_images(imgs))
    assert got.shape == (3, 128) and got.dtype == np.float32
    if fast:
        assert cosines(got, want).min() >= 0.999
    else:
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    # features are not normalised
    assert np.abs(np.linalg.norm(got, axis=-1) - 1).max() > 0.1
    with pytest.raises(NotImplementedError, match="text"):
        port.encode_text("x")
    with pytest.raises(NotImplementedError, match="text"):
        port.encode_batch_texts(["x"])


def test_vit_encoder_blocks_route_to_the_fused_ops(monkeypatch):
    from emr2a_tpu_torch.models import layers
    calls = []
    for name in ("fused_ln_mlp", "fused_ln_attention", "fused_ln_mlp_int8",
                 "fused_ln_attention_int8"):
        fn = getattr(layers, name)
        monkeypatch.setattr(layers, name, lambda *a, _f=fn, _n=name, **k:
                            calls.append(_n) or _f(*a, **k))
    for fast, want in ((True, {"fused_ln_mlp", "fused_ln_attention"}),
                       ("int8", {"fused_ln_mlp_int8", "fused_ln_attention_int8"})):
        calls.clear()
        _, port = _vit_pair(fast)
        port.encode_batch_images(images(1))
        assert sorted(calls) == sorted(list(want) * 2), (fast, calls)


def test_vit_encoder_other_size_takes_crop_pct_geometry():
    jax_enc, port = _vit_pair(False, image_size=160)
    assert (port.preprocess.resize_size, port.preprocess.crop_size) == (177, 160)
    imgs = images(2)
    want = np.stack(jax_enc.encode_batch_images(imgs))
    np.testing.assert_allclose(np.stack(port.encode_batch_images(imgs)), want,
                               atol=ATOL, rtol=RTOL)


def test_vit_checkpoint_keys_and_model_path(tmp_path):
    from emr2a_tpu.encoders.vit_encoder import clean_checkpoint_keys as jax_clean
    from emr2a_tpu_torch.encoders.vit_encoder import ViTEncoder, clean_checkpoint_keys
    from emr2a_tpu_torch.models.vit import TIMM_VIT_B16

    sd = {"module.blocks.0.x": 1, "model.cls_token": 2, "pos_embed": 3}
    assert clean_checkpoint_keys(sd) == jax_clean(sd)
    # a timm-named checkpoint, wrapped in "module.", loads through the path
    _, port = _vit_pair(False)
    cfg = port.image_model.config
    r = np.random.RandomState(0)
    d, m = cfg.hidden_size, cfg.mlp_dim
    timm = {"cls_token": r.randn(1, 1, d), "pos_embed": r.randn(1, 50, d) * 0.02,
            "patch_embed.proj.weight": r.randn(d, 3, 32, 32) * 0.02,
            "patch_embed.proj.bias": r.randn(d) * 0.01,
            "fc_norm.weight": 1 + r.randn(d) * 0.1, "fc_norm.bias": r.randn(d) * 0.1}
    for i in range(2):
        p = f"blocks.{i}."
        timm.update({p + "attn.qkv.weight": r.randn(3 * d, d) * 0.05,
                     p + "attn.qkv.bias": r.randn(3 * d) * 0.01,
                     p + "attn.proj.weight": r.randn(d, d) * 0.05,
                     p + "attn.proj.bias": r.randn(d) * 0.01,
                     p + "norm1.weight": np.ones(d), p + "norm1.bias": np.zeros(d),
                     p + "norm2.weight": np.ones(d), p + "norm2.bias": np.zeros(d),
                     p + "mlp.fc1.weight": r.randn(m, d) * 0.05, p + "mlp.fc1.bias": np.zeros(m),
                     p + "mlp.fc2.weight": r.randn(d, m) * 0.05, p + "mlp.fc2.bias": np.zeros(d)})
    torch.save({"module." + k: torch.tensor(v, dtype=torch.float32) for k, v in timm.items()},
               tmp_path / "vit.bin")
    from emr2a_tpu.encoders.vit_encoder import ViTEncoder as JaxViT
    from emr2a_tpu.models.vit import TIMM_VIT_B16 as JAX_TIMM
    small = dict(patch_size=32, hidden_size=d, num_layers=2, num_heads=2, mlp_dim=m)
    jax_enc = JaxViT(model_path=str(tmp_path / "vit.bin"), device="cpu",
                     config=dataclasses.replace(JAX_TIMM, **small))
    port = ViTEncoder(model_path=str(tmp_path / "vit.bin"), device="cpu",
                      config=dataclasses.replace(TIMM_VIT_B16, **small))
    imgs = images(2)
    np.testing.assert_allclose(np.stack(port.encode_batch_images(imgs)),
                               np.stack(jax_enc.encode_batch_images(imgs)),
                               atol=ATOL, rtol=RTOL)


# -- CLIP ------------------------------------------------------------------------

def small_hf_clip():
    from transformers import CLIPConfig as HFCLIPConfig, CLIPModel
    cfg = HFCLIPConfig(
        text_config=dict(hidden_size=64, intermediate_size=128,
                         num_hidden_layers=2, num_attention_heads=2,
                         max_position_embeddings=16, vocab_size=100,
                         eos_token_id=99, pad_token_id=99, bos_token_id=98),
        vision_config=dict(hidden_size=64, intermediate_size=128,
                           num_hidden_layers=2, num_attention_heads=2,
                           image_size=32, patch_size=16),
        projection_dim=32)
    torch.manual_seed(0)
    return CLIPModel(cfg).eval(), cfg


@pytest.fixture(scope="module")
def hf_clip():
    model, cfg = small_hf_clip()
    return model, cfg, {k: v.detach().numpy() for k, v in model.state_dict().items()}


class ClipTokenizer:
    """bos 98, one id a word (crc32), eos 99, padded with 99 (the CLIP
    convention: pad = eos)."""

    def __call__(self, texts, padding=None, max_length=16, truncation=True,
                 return_tensors="np"):
        import zlib
        ids = np.full((len(texts), max_length), 99, np.int64)
        for i, t in enumerate(texts):
            toks = [98] + [zlib.crc32(w.encode()) % 90 + 2 for w in t.split()]
            toks = toks[:max_length - 1] + [99]
            ids[i, :len(toks)] = toks
        return {"input_ids": ids, "attention_mask": np.ones_like(ids)}


def test_clip_towers_match_hf_and_jax(hf_clip, rng):
    """Both towers against HF's features and JAX's towers; EOT pooling at
    the first eos and the causal mask (the ids after the eos change
    nothing, the ids before it do)."""
    from emr2a_tpu.models import clip as jclip
    from emr2a_tpu.models.convert import convert_hf_clip_image_tower as jax_img
    from emr2a_tpu.models.convert import convert_hf_clip_text_tower as jax_txt
    from emr2a_tpu_torch.encoders.clip_encoder import clip_config_from_hf
    from emr2a_tpu_torch.models.clip import CLIPImageTower, CLIPTextTower
    from emr2a_tpu_torch.models.convert import (
        convert_hf_clip_image_tower,
        convert_hf_clip_text_tower,
    )
    from emr2a_tpu_torch.models.layers import load_params

    model, hcfg, sd = hf_clip
    cfg = clip_config_from_hf(hcfg.to_dict())
    image = load_params(CLIPImageTower(cfg), convert_hf_clip_image_tower(sd, 2))
    text = load_params(CLIPTextTower(cfg), convert_hf_clip_text_tower(sd, 2))
    from emr2a_tpu.encoders.clip_encoder import clip_config_from_hf as jax_cfg
    jcfg = jax_cfg(hcfg.to_dict())

    pixels = rng.randn(3, 32, 32, 3).astype(np.float32)
    with torch.no_grad():
        hf_img = model.get_image_features(
            pixel_values=torch.tensor(pixels.transpose(0, 3, 1, 2))).numpy()
        got = image(torch.from_numpy(pixels)).numpy()
    want = np.asarray(jclip.CLIPImageTower(jcfg).apply({"params": jax_img(sd, 2)}, pixels))
    np.testing.assert_allclose(got, hf_img, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)

    ids = np.array([[98, 5, 6, 7, 99, 99, 99, 99],
                    [98, 11, 12, 99, 99, 99, 99, 99],
                    [98, 11, 12, 99, 40, 41, 42, 99],
                    [98, 13, 12, 99, 99, 99, 99, 99]], dtype=np.int64)
    with torch.no_grad():
        hf_txt = model.get_text_features(input_ids=torch.tensor(ids)).numpy()
        got = text(torch.from_numpy(ids)).numpy()
    want = np.asarray(jclip.CLIPTextTower(jcfg).apply({"params": jax_txt(sd, 2)},
                                                      ids.astype(np.int32)))
    np.testing.assert_allclose(got, hf_txt, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got[1], got[2], atol=1e-6)      # after the eos
    assert np.abs(got[1] - got[3]).max() > 1e-3                # before it


def test_jax_clip_trees_load_into_the_port_unchanged(hf_clip):
    """The JAX package's CLIP trees (token and position embeddings, the
    pre-LN, the projections) through ``params_from_jax`` equal the port's
    own converters' state dicts, and load strictly into its towers."""
    from emr2a_tpu.models.convert import convert_hf_clip_image_tower as jax_img
    from emr2a_tpu.models.convert import convert_hf_clip_text_tower as jax_txt
    from emr2a_tpu_torch.encoders.clip_encoder import clip_config_from_hf
    from emr2a_tpu_torch.models.clip import CLIPImageTower, CLIPTextTower
    from emr2a_tpu_torch.models.convert import (
        convert_hf_clip_image_tower,
        convert_hf_clip_text_tower,
        params_to_jax,
    )

    model, hcfg, sd = hf_clip
    cfg = clip_config_from_hf(hcfg.to_dict())
    for jax_conv, port_conv, tower in ((jax_img, convert_hf_clip_image_tower, CLIPImageTower),
                                       (jax_txt, convert_hf_clip_text_tower, CLIPTextTower)):
        got, want = params_from_jax(jax_conv(sd, 2)), port_conv(sd, 2)
        assert set(got) == set(want) == set(tower(cfg).state_dict())
        assert all(torch.equal(got[k], want[k]) for k in want)
        back = params_from_jax(params_to_jax(got))
        assert all(torch.equal(back[k], got[k]) for k in got)
        tower(cfg).load_state_dict(got, strict=True)


def test_hf_vit_converter_and_preset_match_jax(rng):
    """``convert_hf_vit`` with ``HF_VIT_B16``'s conventions (eps 1e-12, LN
    then the mean of the patches) against HF's ViTModel and JAX's tower;
    the presets and preprocess specs equal JAX's."""
    from transformers import ViTConfig as HFViTConfig, ViTModel

    import emr2a_tpu.models.vit as jvit
    import emr2a_tpu.ops.preprocess as jpre
    from emr2a_tpu.models.convert import convert_hf_vit as jax_convert
    import emr2a_tpu_torch.models.vit as pvit
    import emr2a_tpu_torch.ops.preprocess as ppre
    from emr2a_tpu_torch.models.convert import convert_hf_vit
    from emr2a_tpu_torch.models.layers import load_params

    for name in ("CLIP_VIT_B16_VISION", "CLIP_VIT_L14_336_VISION", "HF_VIT_B16",
                 "TIMM_VIT_B16", "BIOMEDCLIP_VIT_B16"):
        a, b = dataclasses.asdict(getattr(pvit, name)), dataclasses.asdict(getattr(jvit, name))
        assert {k: v for k, v in a.items() if k != "dtype"} == \
            {k: v for k, v in b.items() if k != "dtype"}, name
    for name in ("CLIP_PREPROCESS", "VIT_PREPROCESS", "TIMM_VIT_PREPROCESS",
                 "DINOV3_PREPROCESS"):
        assert dataclasses.asdict(getattr(ppre, name)) == \
            dataclasses.asdict(getattr(jpre, name)), name
    hcfg = HFViTConfig(hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
                       intermediate_size=128, image_size=32, patch_size=16)
    torch.manual_seed(1)
    model = ViTModel(hcfg, add_pooling_layer=False).eval()
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    small = dict(image_size=32, patch_size=16, hidden_size=64, num_layers=2, num_heads=2,
                 mlp_dim=128)
    tower = load_params(pvit.VisionTransformer(dataclasses.replace(pvit.HF_VIT_B16, **small)),
                        convert_hf_vit(sd, 2))
    pixels = rng.randn(2, 32, 32, 3).astype(np.float32)
    with torch.no_grad():
        hf = model(torch.tensor(pixels.transpose(0, 3, 1, 2))).last_hidden_state.numpy()
        got = tower(torch.from_numpy(pixels)).numpy()
    want = np.asarray(jvit.VisionTransformer(dataclasses.replace(jvit.HF_VIT_B16, **small))
                      .apply({"params": jax_convert(sd, 2)}, pixels))
    np.testing.assert_allclose(got, hf[:, 1:].mean(axis=1), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("fast", [False, True, "int8"])
def test_clip_encoder_matches_jax(hf_clip, fast, tmp_path_factory):
    """Both packages' encoders from one ``save_pretrained`` directory (the
    ``model_path`` route) with one tokenizer: image and text embeddings,
    L2-normalised. With ``fast="int8"`` both towers are W8A8 and the text
    blocks' projections take the streaming W8A8 op."""
    from emr2a_tpu.encoders.clip_encoder import CLIPEncoder as JaxCLIP
    from emr2a_tpu_torch.encoders.clip_encoder import CLIPEncoder
    from emr2a_tpu_torch.models.layers import Int8Dense

    model, _, _ = hf_clip
    path = tmp_path_factory.mktemp("clip")
    model.save_pretrained(path)
    tok = ClipTokenizer()
    jax_enc = JaxCLIP(model_path=str(path), device="cpu", tokenizer=tok, fast=fast)
    port = CLIPEncoder(model_path=str(path), device="cpu", tokenizer=tok, fast=fast)
    imgs = images(3)
    texts = ["性别: 男 年龄: 63", "发热 咳嗽 气促", "normal chest"]
    for got, want in ((port.encode_batch_images(imgs), jax_enc.encode_batch_images(imgs)),
                      (port.encode_batch_texts(texts), jax_enc.encode_batch_texts(texts))):
        got = np.stack(got)
        want = np.stack([np.asarray(w, np.float32) for w in want])
        np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1, atol=1e-5)
        if fast:
            assert cosines(got, want).min() >= 0.999
        else:
            np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    n_int8 = sum(isinstance(m, Int8Dense) for m in port.text_model.modules())
    assert n_int8 == (12 if fast == "int8" else 0)


def test_clip_random_init_and_routing_rule():
    """``random_init`` builds both towers; the blocks route by the
    reference's rule exactly as JAX's do: at ViT-B/16 both halves fuse in
    bf16; at ViT-L/14-336 (S = 577, padded to 584) the attention never fuses
    (not even with int8 weights: its projections then take the streaming
    W8A8 op) and the MLP fuses only with int8 weights (K2)."""
    from emr2a_tpu.ops.attention_block import pick_fused_attn_params as jax_pick
    from emr2a_tpu_torch.encoders.clip_encoder import CLIPEncoder
    from emr2a_tpu_torch.models.clip import CLIPConfig
    from emr2a_tpu_torch.models.layers import fused_mlp_fits
    from emr2a_tpu_torch.models.text import CLIPTextConfig
    from emr2a_tpu_torch.models.vit import CLIP_VIT_B16_VISION, CLIP_VIT_L14_336_VISION
    from emr2a_tpu_torch.ops.attention_block import pick_fused_attn_params

    L = CLIP_VIT_L14_336_VISION
    S = L.num_patches + 1 + (-(L.num_patches + 1)) % 8
    assert (L.num_patches + 1, S) == (577, 584)
    for itemsize, mlp_fused in ((2, False), (1, True)):
        assert pick_fused_attn_params(1024, S, 16, weight_itemsize=itemsize) is None
        assert jax_pick(1024, S, 16, weight_itemsize=itemsize) is None
        assert fused_mlp_fits(1024, 4096, itemsize) == mlp_fused
    B = CLIP_VIT_B16_VISION
    assert pick_fused_attn_params(768, 200, 12, weight_itemsize=2) == \
        jax_pick(768, 200, 12, weight_itemsize=2) != None      # noqa: E711
    assert fused_mlp_fits(B.hidden_size, B.mlp_dim, 2)
    cfg = CLIPConfig(vision=dataclasses.replace(B, patch_size=32, hidden_size=128,
                                                num_heads=2, mlp_dim=256, num_layers=1),
                     text=CLIPTextConfig(vocab_size=100, max_length=16, hidden_size=64,
                                         num_layers=1, num_heads=2, mlp_dim=128,
                                         eos_token_id=99),
                     projection_dim=32)
    enc = CLIPEncoder.random_init(cfg, tokenizer=ClipTokenizer(), device="cpu")
    assert np.stack(enc.encode_batch_images(images(2))).shape == (2, 32)
    assert np.stack(enc.encode_batch_texts(["a b", "c"])).shape == (2, 32)
    again = CLIPEncoder.random_init(cfg, device="cpu")
    a, b = (e.image_model.state_dict() for e in (enc, again))
    assert all(torch.equal(a[k], b[k]) for k in a)


# -- Qwen3VLEncoder ---------------------------------------------------------

class ToyTokenizer:
    """The reference test's tokenizer: crc32 words to ids."""

    eos_token_id = 1

    def __call__(self, text, add_special_tokens=False, return_tensors=None):
        import zlib
        ids = [zlib.crc32(tok.encode()) % 150 + 2 for tok in text.split()]
        if return_tensors == "np":
            return {"input_ids": np.asarray([ids], dtype=np.int64)}
        return {"input_ids": ids}


@pytest.fixture(scope="module")
def tiny_qwen():
    import emr2a_tpu.models.qwen3_vl as jq
    from emr2a_tpu_torch.models import qwen3_vl as pq
    from tests.test_torch_qwen3_vl import tiny_hf_model
    model, cfg = tiny_hf_model()
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    jparams = jq.convert_hf_qwen3_vl(sd, vision_depth=3, text_layers=2)
    return (jq.qwen3_vl_config_from_hf(cfg.to_dict()), jparams,
            pq.qwen3_vl_config_from_hf(cfg.to_dict()), params_from_jax(jparams))


def _qwen_pair(tiny_qwen, **kw):
    from emr2a_tpu.encoders.qwen3_vl_encoder import Qwen3VLEncoder as JaxQwen
    from emr2a_tpu.encoders.qwen3_vl_encoder import make_image_processor as jax_proc
    from emr2a_tpu_torch.encoders.qwen3_vl_encoder import Qwen3VLEncoder, make_image_processor
    jcfg, jparams, pcfg, state = tiny_qwen
    limits = dict(min_pixels=16, max_pixels=16384)
    jax_enc = JaxQwen(config=jcfg, params=jparams, tokenizer=ToyTokenizer(),
                      image_processor=jax_proc(jcfg.vision, **limits), **kw)
    port = Qwen3VLEncoder(config=pcfg, params=state, tokenizer=ToyTokenizer(),
                          device="cpu",
                          image_processor=make_image_processor(pcfg.vision, **limits), **kw)
    return jax_enc, port


@pytest.mark.parametrize("target_layers", [[-3, -2, -1], [-2, -1], [0]])
def test_qwen_encoder_taps_match_jax(tiny_qwen, rng, target_layers):
    jax_enc, port = _qwen_pair(tiny_qwen, target_layers=target_layers)
    imgs = [(rng.rand(16, 16, 3) * 255).astype(np.uint8),
            (rng.rand(24, 16, 3) * 255).astype(np.uint8)]
    got = port.encode_batch_images(imgs + [None])
    want = jax_enc.encode_batch_images(imgs + [None])
    assert got[2] is None and want[2] is None
    for g, w in zip(got[:2], want[:2]):
        assert g.shape == (32,) and g.dtype == np.float32
        np.testing.assert_allclose(g, w, atol=5e-4, rtol=1e-3)


def test_qwen_encoder_text_mean_matches_jax_and_bucketing_is_exact(tiny_qwen):
    jax_enc, port = _qwen_pair(tiny_qwen)
    texts = ["性别: 男 年龄: 42", "другой текст с несколькими словами", "x"]
    got = port.encode_batch_texts(texts)
    want = jax_enc.encode_batch_texts(texts)
    for g, w in zip(got, want):
        assert g.shape == (48,)
        np.testing.assert_allclose(g, w, atol=5e-4, rtol=1e-3)
    ids = np.asarray(ToyTokenizer()(texts[1], return_tensors="np")["input_ids"])
    unpadded = port._text_embedding(ids, ids.shape[1])
    np.testing.assert_allclose(got[1], unpadded, atol=1e-6, rtol=1e-6)


def test_qwen_encoder_shares_a_built_model_and_raises_as_jax(tiny_qwen):
    from emr2a_tpu.encoders.qwen3_vl_encoder import Qwen3VLEncoder as JaxQwen
    from emr2a_tpu_torch.encoders.qwen3_vl_encoder import Qwen3VLEncoder
    from emr2a_tpu_torch.models.qwen3_vl import Qwen3VLModel
    jcfg, jparams, pcfg, state = tiny_qwen
    model = Qwen3VLModel.from_params(pcfg, state)
    enc = Qwen3VLEncoder(model=model, tokenizer=ToyTokenizer())
    assert enc.model is model and enc.config is pcfg
    _, port = _qwen_pair(tiny_qwen)
    np.testing.assert_array_equal(enc.encode_batch_texts(["a b c"])[0],
                                  port.encode_batch_texts(["a b c"])[0])
    for ctor, kw in ((JaxQwen, {}), (Qwen3VLEncoder, {})):
        with pytest.raises(ValueError, match=r"needs model_path or \(config, params\)"):
            ctor(**kw)
    msgs = []
    for ctor, cfg, params in ((JaxQwen, jcfg, jparams), (Qwen3VLEncoder, pcfg, state)):
        with pytest.raises(ValueError) as e:
            ctor(config=cfg, params=params, target_layers=[-9, 7], device="cpu")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "out of range" in msgs[0]
    with pytest.raises(NotImplementedError, match="tokenizer"):
        Qwen3VLEncoder(model=model).encode_batch_texts(["x"])


def test_qwen_checkpoint_writer_and_model_path(tiny_qwen, tmp_path):
    """``tools/qwen_checkpoint.write_checkpoint`` writes HF's names and
    layouts (every tensor equal to the HF model's own, read back with the
    ``safetensors`` package), and the encoder's ``model_path`` route reads
    it (bf16 weights, as ``load_qwen3_vl`` loads them): its taps and text
    mean agree with the f32 encoder's and with JAX's encoder on the same
    directory."""
    from safetensors.numpy import load_file

    from emr2a_tpu.encoders.qwen3_vl_encoder import Qwen3VLEncoder as JaxQwen
    from emr2a_tpu.encoders.qwen3_vl_encoder import make_image_processor as jax_proc
    from emr2a_tpu_torch.encoders.qwen3_vl_encoder import Qwen3VLEncoder, make_image_processor
    from emr2a_tpu_torch.tools.qwen_checkpoint import write_checkpoint
    from tests.test_torch_qwen3_vl import tiny_hf_model

    hf, _ = tiny_hf_model()
    jcfg, jparams, pcfg, state = tiny_qwen
    write_checkpoint(tmp_path / "ckpt", pcfg, state)
    got = load_file(str(tmp_path / "ckpt" / "model.safetensors"))
    want = {k: v.detach().numpy() for k, v in hf.state_dict().items()}
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    limits = dict(min_pixels=16, max_pixels=16384)
    port = Qwen3VLEncoder(model_path=str(tmp_path / "ckpt"), device="cpu",
                          tokenizer=ToyTokenizer(),
                          image_processor=make_image_processor(pcfg.vision, **limits))
    assert next(port.model.parameters()).dtype == torch.bfloat16
    jax_enc = JaxQwen(model_path=str(tmp_path / "ckpt"), tokenizer=ToyTokenizer(),
                      cache_params=False, image_processor=jax_proc(jcfg.vision, **limits))
    _, f32 = _qwen_pair(tiny_qwen)
    img = [(np.random.RandomState(4).rand(16, 16, 3) * 255).astype(np.uint8)]
    for enc_fn in (lambda e: e.encode_batch_images(img), lambda e: e.encode_batch_texts(["a b"])):
        a = np.stack(enc_fn(port))
        assert cosines(a, np.stack(enc_fn(f32))).min() >= 0.999
        assert cosines(a, np.stack([np.asarray(w, np.float32) for w in enc_fn(jax_enc)])
                       ).min() >= 0.999


# -- the factory and the CV runner -------------------------------------------

@pytest.fixture()
def small_presets(monkeypatch):
    """The random-init families (vit, dino) at a tiny width in both
    packages, so that the factory's default paths build quickly."""
    import emr2a_tpu.encoders.dino_encoder as jdino
    import emr2a_tpu.encoders.vit_encoder as jvit
    import emr2a_tpu_torch.encoders.dino_encoder as pdino
    import emr2a_tpu_torch.encoders.vit_encoder as pvit
    vit = dict(patch_size=32, hidden_size=64, num_layers=1, num_heads=2, mlp_dim=128)
    dino = dict(hidden_size=64, num_layers=1, num_heads=2, mlp_dim=128)
    for mod in (jvit, pvit):
        monkeypatch.setattr(mod, "TIMM_VIT_B16", dataclasses.replace(mod.TIMM_VIT_B16, **vit))
    for mod in (jdino, pdino):
        monkeypatch.setattr(mod, "DINOV3_VITL16",
                            dataclasses.replace(mod.DINOV3_VITL16, **dino))


def _outcome(create, et, **kw):
    try:
        return type(create(et, device="cpu", **kw)).__name__
    except Exception as e:           # noqa: BLE001 - the outcome is compared
        return f"{type(e).__name__}: {e}"


def test_factory_builds_and_raises_as_jax(small_presets, mesh8):
    from emr2a_tpu.encoders.factory import SUPPORTED_TYPES as JAX_TYPES
    from emr2a_tpu.encoders.factory import create_encoder as jax_create
    from emr2a_tpu_torch.encoders import factory
    assert factory.SUPPORTED_TYPES == JAX_TYPES
    assert not hasattr(factory, "PORTED_TYPES")
    outcomes = {}
    for et in JAX_TYPES + ["nope"]:
        for kw in ({}, {"fast": True}, {"mesh": "m"}):
            got, want = _outcome(factory.create_encoder, et, **kw), _outcome(jax_create, et, **kw)
            if kw.get("mesh") and not (et.startswith("qwen") or et == "fake") and got != want:
                # a mesh that is not the port's Mesh: the port's own clear error
                assert got == "TypeError: mesh must be an emr2a_tpu_torch.parallel.Mesh, got str", (
                    et, got, want)
                assert want.split(":")[0].endswith("Error"), (et, want)
            else:
                assert got == want, (et, kw)
            outcomes[et, tuple(kw)] = got
    assert outcomes["vit", ()] == "ViTEncoder" and outcomes["dino", ("fast",)] == "DINOEncoder"
    from emr2a_tpu_torch.parallel import create_mesh
    port_mesh = create_mesh((8, 1), devices=["cpu"] * 8)
    for et in ("vit", "dino", "fake"):     # a real mesh builds in both packages
        assert (_outcome(factory.create_encoder, et, mesh=port_mesh)
                == _outcome(jax_create, et, mesh=mesh8)), et
    assert outcomes["clip", ()].startswith("ValueError: CLIPEncoder needs model_path")
    assert outcomes["qwen3_vl_2b", ("fast",)].startswith("ValueError: encoder type 'qwen3_vl_2b'")
    assert "NotImplementedError" not in " ".join(outcomes.values())


def test_factory_config_kwargs_reach_the_encoders(small_presets, tmp_path, hf_clip):
    from emr2a_tpu_torch.encoders import CLIPEncoder, DINOEncoder, create_encoder
    model, _, _ = hf_clip
    model.save_pretrained(tmp_path / "clip")
    enc = create_encoder("clip_vit_large_patch14_336", device="cpu",
                         clip_config={"model_path": str(tmp_path / "clip")},
                         tokenizer=ClipTokenizer())
    assert isinstance(enc, CLIPEncoder) and enc.config.vision.hidden_size == 64
    assert enc.encode_text("a b").shape == (32,)
    dino = create_encoder("dinov3_vitl16", device="cpu", fast="int8")
    assert isinstance(dino, DINOEncoder) and dino.encode_text("x") is None
    assert dino.encode_batch_images(images(1))[0].shape == (64,)


def test_cv_driver_with_a_qwen_text_encoder_matches_jax(tiny_qwen, tmp_path, monkeypatch):
    """The CV driver's ``--text_encoder qwen3_vl_8b`` with each package's
    Qwen3VLEncoder (the tiny model, a toy tokenizer) patched into its
    driver's ``create_encoder``, on 24 patients whose clinical texts
    differ: fold ``metrics.json`` equal (scores within the CV tests'
    1e-4)."""
    from PIL import Image

    from emr2a_tpu.analysis import run_cv_experiments as jax_runner
    from emr2a_tpu_torch.analysis import run_cv_experiments as port_runner
    from emr2a_tpu_torch.data.manifest import save_manifest
    from tests.test_torch_cv import _assert_experiment_equal, _run_both

    r = np.random.RandomState(11)
    symptoms = ["咳嗽", "气促", "胸痛", "乏力", "咳痰", "呼吸困难", "寒战", "头痛"]
    records = []
    for i in range(24):
        label = ["Bacterial", "Viral", "PJP", "Normal"][i % 4]
        p = tmp_path / f"s{i}.png"
        Image.fromarray((r.rand(16, 16, 3) * 255).astype(np.uint8)).save(p)
        records.append({"patient_id": f"{label}_{i}", "label": label, "slices": [str(p)],
                        "meta": {"sex": "男女"[i % 2], "age": str(r.randint(20, 90)),
                                 "fever": "有无"[r.randint(2)],
                                 "symptom": " ".join(r.choice(symptoms, 1 + i % 3,
                                                              replace=False))}})
    mpath = tmp_path / "manifest.jsonl"
    save_manifest(records, mpath)
    jax_enc, port = _qwen_pair(tiny_qwen)
    for runner, enc in ((jax_runner, jax_enc), (port_runner, port)):
        make = runner.create_encoder
        monkeypatch.setattr(runner, "create_encoder", lambda et, *a, _m=make, _e=enc, **k:
                            _e if et == "qwen3_vl_8b" else _m(et, *a, **k))
    got, want = _run_both(tmp_path, monkeypatch, mpath,
                          ["--experiment_id", "qw", "--text_encoder", "qwen3_vl_8b",
                           "--fusion", "text_only", "--cv_folds", "3"])
    _assert_experiment_equal(got / "exp_qw", want / "exp_qw")
