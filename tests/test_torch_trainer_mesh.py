"""The port's contrastive trainer over a mesh's data and model axes
(``emr2a_tpu_torch/training/clip_trainer.py``, ``ShardedAttention`` /
``ShardedMlp`` in ``models/layers.py``) on an 8-device CPU mesh, at JAX's
tiny CLIP towers (``tests/test_training.py``), one seeded random init
(``models/clip.init_tower``) carried to JAX's tree by ``params_to_jax``:

- ``spec_for_param`` equals JAX's for every leaf of both towers, and the
  placement's chunks have the shapes of JAX's shards
  (``test_tp_weights_actually_sharded``);
- at meshes (8, 1), (4, 2) and (2, 4) (JAX's ``test_contrastive_train_step``
  cases), 3 AdamW steps give the one-device port's losses within rtol 1e-5,
  and the loss falls; at (4, 2) JAX's own ``ContrastiveTrainer(mesh=)`` on
  the same params and batch gives the port's mesh losses within the
  one-device JAX test's tolerances (``tests/test_torch_trainer.py``);
- save / restore resumes exactly across meshes: the file holds whole
  tensors, a state saved on one mesh restores bit for bit on another (and
  on one device), and the resumed losses equal 4 straight steps';
- a mesh that is not a ``parallel.Mesh`` raises ``TypeError``, and a batch
  that does not divide by the data replicas ``ValueError``.
"""

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
import torch

from emr2a_tpu.models.clip import CLIPConfig as JaxCLIPConfig
from emr2a_tpu.models.clip import CLIPImageTower as JaxImageTower
from emr2a_tpu.models.clip import CLIPTextTower as JaxTextTower
from emr2a_tpu.models.text import CLIPTextConfig as JaxTextConfig
from emr2a_tpu.models.vit import ViTConfig as JaxViTConfig
from emr2a_tpu.parallel.mesh import create_mesh as jax_create_mesh
from emr2a_tpu.training import ContrastiveTrainer as JaxTrainer
from emr2a_tpu.training import param_shardings as jax_param_shardings
from emr2a_tpu_torch.models.clip import init_tower
from emr2a_tpu_torch.models.convert import params_from_jax, params_to_jax
from emr2a_tpu_torch.parallel import create_mesh, shard_params
from emr2a_tpu_torch.training import ContrastiveTrainer, param_shardings
from tests.test_torch_tp import jax_specs_by_port_key
from tests.test_torch_trainer import LR, TEXT, VISION, _port_towers

torch.set_num_threads(1)
CPU8 = [torch.device("cpu")] * 8


@pytest.fixture(scope="module")
def setup():
    """(JAX trees, port state dicts, pixels, ids, the one-device port's 4
    losses)."""
    gen = torch.Generator().manual_seed(0)
    towers = [init_tower(t, gen) for t in _port_towers()]
    params = {t: params_to_jax({k: v.numpy() for k, v in m.state_dict().items()})
              for t, m in zip(("image", "text"), towers)}
    rng = np.random.RandomState(0)
    pixels = rng.randn(16, 32, 32, 3).astype(np.float32)
    ids = rng.randint(0, 62, (16, 16)).astype(np.int32)
    ids[:, -1] = 63
    port = {t: params_from_jax(params[t]) for t in ("image", "text")}
    one = ContrastiveTrainer(*_port_towers(), learning_rate=LR)
    return params, port, pixels, ids, _run(one, port, pixels, ids, 4)[1]


def _run(trainer, params, pixels, ids, steps, state=None):
    state = trainer.init_state(params) if state is None else state
    step = trainer.make_train_step()
    losses = []
    for _ in range(steps):
        state, loss = step(state, pixels, ids, None)
        losses.append(float(loss))
    return state, losses


def _trainer(shape):
    return ContrastiveTrainer(*_port_towers(), mesh=create_mesh(shape, devices=CPU8),
                              learning_rate=LR)


def test_specs_equal_jax_for_every_tower_leaf(setup, mesh8):
    params, port, *_ = setup
    for t in ("image", "text"):
        assert param_shardings(port)[t] == jax_specs_by_port_key(params[t])
    got = param_shardings(port)["image"]
    assert got["vision.blocks.0.attn.q_proj.kernel"] == (None, "model")
    assert got["vision.blocks.0.attn.out_proj.kernel"] == ("model", None)
    assert got["vision.blocks.0.mlp.fc1.bias"] == ("model",)
    assert got["vision.blocks.0.mlp.fc2.bias"] == ()


def test_shard_shapes_equal_jax(setup, mesh8):
    params, port, *_ = setup
    jmesh = jax_create_mesh((4, 2))
    image = {"image": params["image"]}
    sharded = jtu.tree_map(jax.device_put, image, jax_param_shardings(image, jmesh))
    k = sharded["image"]["vision"]["block_0"]["attn"]["q_proj"]["kernel"]
    want = {s.data.shape for s in k.addressable_shards}
    parts = shard_params(port["image"], create_mesh((4, 2), devices=CPU8))
    assert len(parts) == 2
    assert {tuple(p["vision.blocks.0.attn.q_proj.kernel"].shape) for p in parts} == want
    assert [tuple(p["vision.blocks.0.attn.out_proj.kernel"].shape) for p in parts] == [(32, 64)] * 2
    whole = port["image"]["vision.blocks.0.attn.q_proj.kernel"]
    assert torch.equal(torch.cat([p["vision.blocks.0.attn.q_proj.kernel"] for p in parts], 1),
                       whole)


@pytest.mark.parametrize("shape", [(8, 1), (4, 2), (2, 4)])
def test_mesh_losses_equal_one_device(setup, shape):
    _, port, pixels, ids, ref = setup
    state, losses = _run(_trainer(shape), port, pixels, ids, 3)
    assert state.step == 3 and len(state.params) == shape[0]
    np.testing.assert_allclose(losses, ref[:3], rtol=1e-5)
    assert losses[-1] < losses[0]


def test_mesh_losses_equal_jax_mesh(setup, mesh8):
    """The port at (4, 2) against JAX's trainer on the same (4, 2) mesh of
    the 8 CPU devices: the losses, the first within rtol 1e-5 and all
    within 1e-4, as the one-device JAX test holds them."""
    params, port, pixels, ids, _ = setup
    cfg = JaxCLIPConfig(vision=JaxViTConfig(**VISION), text=JaxTextConfig(**TEXT),
                        projection_dim=32)
    img, txt = JaxImageTower(cfg), JaxTextTower(cfg)
    jt = JaxTrainer(image_apply=lambda p, x: img.apply({"params": p["image"]}, x),
                    text_apply=lambda p, i, m: txt.apply({"params": p["text"]}, i),
                    mesh=jax_create_mesh((4, 2)), learning_rate=LR)
    jstate, jstep = jt.init_state(params), jt.make_train_step()
    jlosses = []
    for _ in range(3):
        jstate, loss = jstep(jstate, jnp.asarray(pixels), jnp.asarray(ids), None)
        jlosses.append(float(loss))
    state, losses = _run(_trainer((4, 2)), port, pixels, ids, 3)
    assert state.step == 3 and int(jstate.step) == 3
    np.testing.assert_allclose(losses[0], jlosses[0], rtol=1e-5)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    assert losses[-1] < losses[0]


def test_resume_exact_across_meshes(setup, tmp_path):
    _, port, pixels, ids, ref = setup
    a = _trainer((4, 2))
    saved, _ = _run(a, port, pixels, ids, 2)
    a.save_state(saved, tmp_path / "ckpt")
    whole = a.whole_params(saved)
    for restore_on in (_trainer((2, 4)), ContrastiveTrainer(*_port_towers(), learning_rate=LR)):
        s = restore_on.restore_state(restore_on.init_state(port), tmp_path / "ckpt")
        assert s.step == 2
        got = restore_on.whole_params(s)
        for t in whole:
            for k, v in whole[t].items():
                assert torch.equal(got[t][k], v), (t, k)
        _, resumed = _run(restore_on, port, pixels, ids, 2, state=s)
        np.testing.assert_allclose(resumed, ref[2:], rtol=1e-5)
    # and a one-device checkpoint resumes on a mesh
    one = ContrastiveTrainer(*_port_towers(), learning_rate=LR)
    s1, _ = _run(one, port, pixels, ids, 2)
    one.save_state(s1, tmp_path / "one")
    b = _trainer((2, 4))
    s = b.restore_state(b.init_state(port), tmp_path / "one")
    _, resumed = _run(b, port, pixels, ids, 2, state=s)
    np.testing.assert_allclose(resumed, ref[2:], rtol=1e-5)


def test_mesh_type_and_batch_are_checked(setup):
    _, port, pixels, ids, _ = setup
    with pytest.raises(TypeError, match="parallel.Mesh"):
        ContrastiveTrainer(*_port_towers(), mesh=object())
    trainer = _trainer((8, 1))
    with pytest.raises(ValueError, match="does not divide"):
        trainer.make_train_step()(trainer.init_state(port), pixels[:12], ids[:12], None)
