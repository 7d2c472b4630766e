"""The mesh's model axis (``emr2a_tpu_torch/parallel/tensor.py``,
``training/sharding_rules.py``, ``models/qwen3_vl.py``'s shards) on the
CPU, at the JAX serving suite's tiny Qwen3-VL (``tests/test_speculative.
tiny_config``: width 64, 4 heads over 2 kv heads, f32), one seeded random
state (``tiny_state``) loaded into both packages, on an 8-device CPU mesh
of (4, 2):

- ``spec_for_param`` equals JAX's for every leaf of the Qwen tree in f32,
  int8, int4 and the fused int8 layout (quantized projections whole, a
  column-parallel bias sharded);
- ``kv_cache_sharding_specs`` equals JAX's (the replicated fallback and no
  mesh included), and ``constrain_kv_cache`` / ``empty_kv_cache`` place the
  cache on its kv heads;
- the q/k/v kernels' shards have the shapes of JAX's
  (``test_tp_weights_actually_sharded``), and ``shard_params`` /
  ``unshard_param`` round-trip; every sharded leaf's chunk owns a storage
  of its own size, card 0's too (a view would keep the whole tensor
  resident);
- the collectives: ``all_reduce`` adds in card order, every card with the
  same bits, ``all_gather`` concatenates in card order;
- the text forward (and the multimodal one) at (4, 2) against JAX's
  replicated golden, atol 2e-4 and rtol 1e-3 (JAX's tolerance in
  ``tests/test_qwen_tp_sharding.py``), and the int8 / int4 / fused / biased
  shards against the one-card model;
- ``tensor_parallel`` refuses a mesh that is not a ``parallel.Mesh`` and a
  model axis that does not divide the heads, naming the sizes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from emr2a_tpu.models.quantize import quantize_qwen_text_params as jax_quantize
from emr2a_tpu.models.qwen3_vl import Qwen3VLModel as JaxQwen3VLModel
from emr2a_tpu.models.qwen3_vl import kv_cache_sharding_specs as jax_kv_specs
from emr2a_tpu.parallel.mesh import create_mesh as jax_create_mesh
from emr2a_tpu.training import param_shardings as jax_param_shardings
from emr2a_tpu.training.sharding_rules import spec_for_param as jax_spec
from emr2a_tpu_torch.models import qwen3_vl as pq
from emr2a_tpu_torch.models.convert import params_from_jax, params_to_jax
from emr2a_tpu_torch.parallel import (
    all_gather,
    all_reduce,
    create_mesh,
    model_devices,
    shard_params,
    unshard_param,
)
from emr2a_tpu_torch.training import param_shardings
from tests.test_speculative import tiny_config
from tests.test_torch_serving import multimodal_request, port_config

torch.set_num_threads(1)
CPU8 = [torch.device("cpu")] * 8


def cpu_mesh(shape=(4, 2)):
    return create_mesh(shape, devices=CPU8)


def tiny_state(seed=0):
    """A random state of ``port_config()`` drawn on the CPU from ``seed``:
    kernels N(0, 1 / fan_in), the embedding and the position table N(0, 1),
    biases N(0, 0.1), norm scales one."""
    g = torch.Generator().manual_seed(seed)
    state = {}
    for name, ref in pq.Qwen3VLModel(port_config(), device="meta").state_dict().items():
        leaf = name.rsplit(".", 1)[-1]
        std = {"kernel": ref.shape[0] ** -0.5, "embedding": 1.0, "pos_embed": 1.0,
               "bias": 0.1}.get(leaf)
        state[name] = (torch.ones(ref.shape) if std is None
                       else torch.randn(ref.shape, generator=g) * std)
    return state


@pytest.fixture(scope="module")
def tiny():
    """(JAX model, JAX params, port model) over one seeded state."""
    state = tiny_state()
    jparams = params_to_jax({k: v.numpy() for k, v in state.items()})
    return (JaxQwen3VLModel(tiny_config()), jparams,
            pq.Qwen3VLModel.from_params(port_config(), state))


def jax_specs_by_port_key(tree):
    """JAX's spec of every leaf of ``tree``, under the port's state-dict
    key."""
    leaves = jtu.tree_leaves_with_path(tree)
    specs = [tuple(jax_spec(path, v)) for path, v in leaves]
    index = jtu.tree_unflatten(jtu.tree_structure(tree),
                               [np.asarray([i]) for i in range(len(leaves))])
    return {k: specs[int(v[0])] for k, v in params_from_jax(index).items()}


def quantized_tree(jparams, precision, fuse=False):
    tree = dict(jparams)
    tree["language_model"] = jtu.tree_map(np.asarray, jax_quantize(
        jparams["language_model"], precision=precision, fuse_projs=fuse))
    return tree


@pytest.mark.parametrize("precision,fuse", [("f32", False), ("int8", False),
                                            ("int4", False), ("int8", True)])
def test_specs_equal_jax_for_every_qwen_leaf(tiny, precision, fuse):
    _, jparams, _ = tiny
    tree = jparams if precision == "f32" else quantized_tree(jparams, precision, fuse)
    state = params_from_jax(tree)
    got = param_shardings(state)
    assert got == jax_specs_by_port_key(tree)
    layer = "language_model.layers.0."
    if precision == "f32":
        assert got[layer + "q_proj.kernel"] == (None, "model")
        assert got[layer + "o_proj.kernel"] == ("model", None)
        assert got["visual.merger.fc1.bias"] == ("model",)
        assert got["visual.merger.fc2.bias"] == ()
    else:
        # quantized and fused projections stay whole on every card
        assert all(v == () for k, v in got.items() if k.startswith(layer))


def test_kv_cache_specs_equal_jax(tiny, mesh8):
    cfg = port_config().text
    jmesh = jax_create_mesh((4, 2))
    want = jax_kv_specs(tiny_config().text, jmesh)
    got = pq.kv_cache_sharding_specs(cfg, cpu_mesh())
    assert got == tuple(tuple(s) for s in want) == ((None, None, "model", None),
                                                    (None, None, "model"))

    class OddCfg:
        num_kv_heads = 3

    assert pq.kv_cache_sharding_specs(OddCfg, cpu_mesh()) == ((), ())
    assert tuple(jax_kv_specs(OddCfg, jmesh)) == (P(), P())
    assert pq.kv_cache_sharding_specs(cfg, None) == ((), ())
    assert pq.kv_cache_sharding_specs(cfg, cpu_mesh((8, 1))) == ((), ())
    # placed on the kv heads: each card's (B, L, KV / 2, HD) values and
    # (B, L, KV / 2) scales
    whole = pq.empty_kv_cache(cfg, 2, 12, "int8")
    for i, layer in enumerate(whole):
        for j, buf in enumerate(layer):
            buf.copy_(torch.arange(buf.numel()).reshape(buf.shape).to(buf.dtype) + i + j)
    placed = pq.constrain_kv_cache(whole, cpu_mesh(), cfg)
    assert isinstance(placed, pq.ShardedCache) and len(placed) == 2
    assert [tuple(b.shape) for b in placed[1][0]] == [(2, 12, 1, 16), (2, 12, 1),
                                                      (2, 12, 1, 16), (2, 12, 1)]
    for layer, parts in zip(whole, zip(*placed)):
        for j, buf in enumerate(layer):
            assert torch.equal(torch.cat([p[j] for p in parts], dim=2), buf)
    fresh = pq.empty_kv_cache(cfg, 2, 12, "bf16", mesh=cpu_mesh())
    assert [tuple(b.shape) for b in fresh[0][0]] == [(2, 12, 1, 16)] * 2
    assert pq.constrain_kv_cache(whole, None, cfg) is whole


def test_shard_shapes_equal_jax(tiny, mesh8):
    _, jparams, model = tiny
    jmesh = jax_create_mesh((4, 2))
    sharded = jtu.tree_map(jax.device_put, jparams, jax_param_shardings(jparams, jmesh))
    state = model.state_dict()
    parts = shard_params(state, cpu_mesh())
    assert model_devices(cpu_mesh()) == CPU8[:2] and len(parts) == 2
    for jpath, key in (("q_proj", "q_proj.kernel"), ("o_proj", "o_proj.kernel"),
                       ("down_proj", "down_proj.kernel")):
        k = sharded["language_model"]["layer_0"][jpath]["kernel"]
        want = {s.data.shape for s in k.addressable_shards}
        name = "language_model.layers.0." + key
        assert {tuple(p[name].shape) for p in parts} == want
        spec = param_shardings(state)[name]
        assert torch.equal(unshard_param([p[name] for p in parts], spec), state[name])
    assert parts[1]["language_model.embed_tokens.embedding"].shape == (128, 64)


def test_shards_own_their_storage(tiny):
    state = tiny[2].state_dict()
    specs = param_shardings(state)
    parts = shard_params(state, cpu_mesh())
    sharded = [k for k, spec in specs.items() if "model" in spec]
    assert len(sharded) > 10
    for key in sharded:
        source = state[key].untyped_storage().data_ptr()
        for part in parts:
            chunk = part[key]
            assert chunk.is_contiguous(), key
            assert chunk.untyped_storage().nbytes() == chunk.numel() * chunk.element_size(), key
            assert chunk.untyped_storage().data_ptr() != source, key


def test_collectives_add_and_gather_in_card_order():
    rng = np.random.RandomState(1)
    parts = [torch.from_numpy(rng.randn(3, 5).astype(np.float32)) for _ in range(4)]
    want = ((parts[0].double() + parts[1].double()) + parts[2].double()) + parts[3].double()
    out = all_reduce(parts)
    assert all(torch.equal(o, out[0]) for o in out)
    torch.testing.assert_close(out[0].double(), want, rtol=1e-6, atol=1e-6)
    bf = [p.bfloat16() for p in parts]
    assert torch.equal(all_reduce(bf)[2], sum(p.float() for p in bf).bfloat16())
    gathered = all_gather(parts)
    assert all(torch.equal(g, torch.cat(parts, dim=-1)) for g in gathered)
    assert all_reduce(parts[:1])[0] is parts[0]


def test_text_forward_tp_equals_jax_golden(tiny, mesh8):
    jmodel, jparams, model = tiny
    ids = np.array([[3, 5, 8, 13, 21, 34, 2, 9]] * 4, dtype=np.int64)
    pos = pq.compute_mrope_position_ids(ids, (), 120)
    golden, _ = jmodel.apply({"params": jparams}, jnp.asarray(ids), jnp.asarray(pos))
    tp = pq.tensor_parallel(model, cpu_mesh())
    assert isinstance(tp, pq.ShardedQwen3VLModel) and len(tp.language_model.shards) == 2
    shard = tp.language_model.shards[1].layers[0]
    assert tuple(shard.q_proj.kernel.shape) == (64, 32)
    assert tuple(shard.o_proj.kernel.shape) == (32, 64)
    out, cache = tp(torch.from_numpy(ids), torch.from_numpy(pos))
    np.testing.assert_allclose(out.numpy(), np.asarray(golden), atol=2e-4, rtol=1e-3)
    one, _ = model(torch.from_numpy(ids), torch.from_numpy(pos))
    torch.testing.assert_close(out, one, atol=2e-5, rtol=1e-5)


def test_multimodal_forward_tp_equals_jax_golden(tiny, mesh8):
    jmodel, jparams, model = tiny
    req = multimodal_request(np.random.RandomState(3))
    ids, grid = req["input_ids"], req["grid_thw"]
    pos = pq.compute_mrope_position_ids(ids, grid, 120)
    golden, _ = jmodel.apply({"params": jparams}, jnp.asarray(ids), jnp.asarray(pos),
                             pixel_patches=jnp.asarray(req["pixel_patches"]), grid_thw=grid)
    tp = pq.tensor_parallel(model, cpu_mesh())
    out, _ = tp(torch.from_numpy(ids), torch.from_numpy(pos),
                pixel_patches=torch.from_numpy(req["pixel_patches"]), grid_thw=grid)
    np.testing.assert_allclose(out.numpy(), np.asarray(golden), atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("precision,fuse", [("int8", False), ("int4", False), ("int8", True)])
def test_quantized_shards_run_whole_projections(tiny, precision, fuse):
    """A quantized (or fused) projection is whole on every card: each card
    runs it (K5 / K7's plain versions here), keeps its heads' columns, and
    a whole o_proj / down_proj takes the gathered input; the logits equal
    the one-card model's."""
    _, jparams, _ = tiny
    state = params_from_jax(quantized_tree(jparams, precision, fuse))
    one = pq.Qwen3VLModel.from_params(port_config(), state)
    tp = pq.tensor_parallel(one, cpu_mesh())
    layer = tp.language_model.shards[1].layers[0]
    assert layer._whole == ({"o_proj", "down_proj"} if fuse else
                            {"q_proj", "k_proj", "v_proj", "o_proj", "gate_proj",
                             "up_proj", "down_proj"})
    ids = torch.tensor([[3, 5, 8, 13, 21, 34, 2, 9]])
    pos = torch.from_numpy(pq.compute_mrope_position_ids(ids.numpy(), (), 120))
    torch.testing.assert_close(tp(ids, pos)[0], one(ids, pos)[0], atol=2e-5, rtol=1e-5)


def test_quantized_column_bias_is_the_shards_slice():
    """With ``attention_bias`` an int8 q/k/v projection runs whole and adds
    its card's slice of the bias after keeping its columns."""
    cfg = dataclasses.replace(port_config(), text=dataclasses.replace(
        port_config().text, attention_bias=True))
    state = pq.random_state(cfg, seed=4, device="cpu")
    for key in [k for k in state if k.endswith("_proj.bias")]:
        state[key] = torch.randn(state[key].shape, generator=torch.Generator().manual_seed(5))
    from emr2a_tpu_torch.judge.qwen_backend import quantize_decoder
    state = quantize_decoder(state, "int8")
    one = pq.Qwen3VLModel.from_params(cfg, state)
    tp = pq.tensor_parallel(one, cpu_mesh())
    layer = tp.language_model.shards[1].layers[0]
    assert tuple(layer.q_proj.bias.shape) == (32,) and tuple(layer.o_proj.bias.shape) == (64,)
    ids = torch.tensor([[3, 5, 8, 13, 21]])
    pos = torch.from_numpy(pq.compute_mrope_position_ids(ids.numpy(), (), 120))
    torch.testing.assert_close(tp(ids, pos)[0], one(ids, pos)[0], atol=2e-5, rtol=1e-5)


def test_tensor_parallel_refusals(tiny):
    model = tiny[2]
    with pytest.raises(TypeError, match="parallel.Mesh"):
        pq.tensor_parallel(model, object())
    # 4 cards: the tiny vision tower's 2 heads do not divide
    with pytest.raises(ValueError, match="vision num_heads = 2"):
        pq.tensor_parallel(model, cpu_mesh((2, 4)))
    tp = pq.tensor_parallel(model, cpu_mesh())
    assert pq.tensor_parallel(tp, tp.mesh) is tp
    with pytest.raises(ValueError, match="another mesh"):
        pq.tensor_parallel(tp, cpu_mesh())
    # a model axis of one card is the plain model over the same tensors
    plain = pq.tensor_parallel(model, cpu_mesh((8, 1)))
    assert type(plain) is pq.Qwen3VLModel
    assert (plain.language_model.embed_tokens.embedding.data_ptr()
            == model.language_model.embed_tokens.embedding.data_ptr())
