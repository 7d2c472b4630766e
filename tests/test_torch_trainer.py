"""The port's contrastive trainer (``emr2a_tpu_torch/training``) against
the JAX package's (``emr2a_tpu/training/clip_trainer.py``), on the CPU:

- ``clip_contrastive_loss`` within 1e-6 of JAX's;
- JAX's tiny CLIP towers (``tests/test_training.py:15-26``), their params
  carried across by ``params_from_jax``, 3 AdamW steps on both (JAX on a
  one-device mesh; lr 1e-3, weight decay 0.01): the first loss within
  rtol 1e-5, the later ones within rtol 1e-4 (measured 4e-6); every
  parameter within 1e-5 of JAX's (measured 8e-7), except the attention's
  key biases: softmax is invariant to a key bias (it adds q . b to every
  logit of a row), so their true gradient is 0 and both packages' are f32
  rounding noise, which AdamW turns into steps of about lr either way;
  they stay within 6 lr (3 steps of at most lr each, each way);
- ``remat=True`` gives the plain run's losses and params;
- save / restore resumes exactly (JAX's ``test_checkpoint_resume_exact``:
  2 steps, save, restore, 2 more equal 4 straight within rtol 1e-5);
- a ``mesh`` raises ``NotImplementedError`` (ROADMAP item 7), and a tower
  with fused blocks or quantized projections is refused by
  ``init_state``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emr2a_tpu.models.clip import CLIPConfig as JaxCLIPConfig
from emr2a_tpu.models.clip import CLIPImageTower as JaxImageTower
from emr2a_tpu.models.clip import CLIPTextTower as JaxTextTower
from emr2a_tpu.models.text import CLIPTextConfig as JaxTextConfig
from emr2a_tpu.models.vit import ViTConfig as JaxViTConfig
from emr2a_tpu.parallel.mesh import create_mesh
from emr2a_tpu.training import ContrastiveTrainer as JaxTrainer
from emr2a_tpu.training import clip_contrastive_loss as jax_loss
from emr2a_tpu_torch.models.clip import CLIPConfig, CLIPImageTower, CLIPTextTower
from emr2a_tpu_torch.models.convert import params_from_jax
from emr2a_tpu_torch.models.layers import load_params
from emr2a_tpu_torch.models.quantize import quantize_params_tree
from emr2a_tpu_torch.models.text import CLIPTextConfig
from emr2a_tpu_torch.models.vit import ViTConfig
from emr2a_tpu_torch.training import ContrastiveTrainer, clip_contrastive_loss

LR = 1e-3
VISION = dict(image_size=32, patch_size=16, hidden_size=64, num_layers=2, num_heads=2,
              mlp_dim=128, activation="quick_gelu", use_pre_layernorm=True,
              patch_bias=False, pooling="cls_ln")
TEXT = dict(vocab_size=64, max_length=16, hidden_size=64, num_layers=2, num_heads=2,
            mlp_dim=128, eos_token_id=63)


def _port_towers(**vision):
    cfg = CLIPConfig(vision=ViTConfig(**{**VISION, **vision}), text=CLIPTextConfig(**TEXT),
                     projection_dim=32)
    return CLIPImageTower(cfg), CLIPTextTower(cfg)


@pytest.fixture(scope="module")
def jax_setup():
    cfg = JaxCLIPConfig(vision=JaxViTConfig(**VISION), text=JaxTextConfig(**TEXT),
                        projection_dim=32)
    img, txt = JaxImageTower(cfg), JaxTextTower(cfg)
    key = jax.random.PRNGKey(0)
    params = {"image": img.init(key, jnp.zeros((1, 32, 32, 3)))["params"],
              "text": txt.init(key, jnp.zeros((1, 8), jnp.int32))["params"]}
    rng = np.random.RandomState(0)
    pixels = rng.randn(16, 32, 32, 3).astype(np.float32)
    ids = rng.randint(0, 62, (16, 16)).astype(np.int32)
    ids[:, -1] = 63
    return img, txt, jax.tree_util.tree_map(np.asarray, params), pixels, ids


def _port_params(params):
    return {t: params_from_jax(params[t]) for t in ("image", "text")}


def _run(trainer, params, pixels, ids, steps):
    state = trainer.init_state(params)
    step = trainer.make_train_step()
    losses = []
    for _ in range(steps):
        state, loss = step(state, pixels, ids, None)
        losses.append(float(loss))
    return state, losses


def test_contrastive_loss_matches_jax(rng):
    a, b = rng.randn(8, 32).astype(np.float32), rng.randn(8, 32).astype(np.float32)
    for temp in (0.07, 1.0):
        got = clip_contrastive_loss(torch.from_numpy(a), torch.from_numpy(b), temp)
        np.testing.assert_allclose(float(got), float(jax_loss(a, b, temp)), atol=1e-6,
                                   rtol=1e-6)


def test_three_adamw_steps_match_jax(jax_setup):
    img, txt, params, pixels, ids = jax_setup
    mesh = create_mesh((1, 1), devices=jax.devices()[:1])
    jt = JaxTrainer(image_apply=lambda p, x: img.apply({"params": p["image"]}, x),
                    text_apply=lambda p, i, m: txt.apply({"params": p["text"]}, i),
                    mesh=mesh, learning_rate=LR)
    jstate = jt.init_state(params)
    jstep = jt.make_train_step()
    jlosses = []
    for _ in range(3):
        jstate, loss = jstep(jstate, jnp.asarray(pixels), jnp.asarray(ids), None)
        jlosses.append(float(loss))

    state, losses = _run(ContrastiveTrainer(*_port_towers(), learning_rate=LR),
                         _port_params(params), pixels, ids, 3)
    assert state.step == 3
    np.testing.assert_allclose(losses[0], jlosses[0], rtol=1e-5)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    assert losses[-1] < losses[0]
    want = _port_params(jax.tree_util.tree_map(np.asarray, jstate.params))
    for t in ("image", "text"):
        assert sorted(state.params[t]) == sorted(want[t])
        for name, value in want[t].items():
            d = float((state.params[t][name].detach() - value).abs().max())
            limit = 6 * LR if name.endswith("k_proj.bias") else 1e-5
            assert d <= limit, (t, name, d)


def test_remat_matches_plain(jax_setup):
    *_, params, pixels, ids = jax_setup
    plain, lp = _run(ContrastiveTrainer(*_port_towers(), learning_rate=LR),
                     _port_params(params), pixels, ids, 3)
    remat, lr_ = _run(ContrastiveTrainer(*_port_towers(), learning_rate=LR, remat=True),
                      _port_params(params), pixels, ids, 3)
    np.testing.assert_allclose(lr_, lp, rtol=1e-5)
    assert np.isfinite(lr_).all() and lr_[-1] < lr_[0]
    for t in plain.params:
        for name, value in plain.params[t].items():
            np.testing.assert_allclose(remat.params[t][name].detach().numpy(),
                                       value.detach().numpy(), atol=1e-6, err_msg=name)


def test_checkpoint_resume_exact(jax_setup, tmp_path):
    *_, params, pixels, ids = jax_setup
    source = _port_params(params)
    _, ref = _run(ContrastiveTrainer(*_port_towers(), learning_rate=LR), source,
                  pixels, ids, 4)

    trainer = ContrastiveTrainer(*_port_towers(), learning_rate=LR)
    s2, _ = _run(trainer, source, pixels, ids, 2)
    trainer.save_state(s2, tmp_path / "ckpt")

    trainer3 = ContrastiveTrainer(*_port_towers(), learning_rate=LR)
    s3 = trainer3.restore_state(trainer3.init_state(source), tmp_path / "ckpt")
    assert s3.step == 2
    step = trainer3.make_train_step()
    resumed = []
    for _ in range(2):
        s3, loss = step(s3, pixels, ids, None)
        resumed.append(float(loss))
    np.testing.assert_allclose(resumed, ref[2:], rtol=1e-5)
    # init_state copied the caller's tensors: the source is untouched
    assert all(torch.equal(source[t][k], params_from_jax(params[t])[k])
               for t in source for k in source[t])


def test_mesh_raises():
    with pytest.raises(NotImplementedError, match="item 7"):
        ContrastiveTrainer(*_port_towers(), mesh=object())


@pytest.mark.parametrize("how", ["fused_attn", "fused_mlp", "int8"])
def test_kernel_towers_refused(jax_setup, how):
    *_, params, _, _ = jax_setup
    source = _port_params(params)
    image, text = _port_towers(**({how: True} if how != "int8" else {}))
    if how == "int8":
        load_params(image, params_from_jax(quantize_params_tree(params["image"])))
    with pytest.raises(ValueError, match="no backward"):
        ContrastiveTrainer(image, text).init_state(source)
