"""The port's ``models/resnet.py`` and ResNet converters against the JAX
package's flax ResNet-18 (``emr2a_tpu/models/resnet.py``) on the same
numpy-seeded inputs, JAX's variables carried across by
``resnet_from_jax``:

- eval mode: the backbone and both baseline models (atol 2e-4, rtol 1e-3,
  JAX's conversion tolerance, ``tests/test_baselines.py:310``);
- train mode at a batch of 2 patients x 2 slices of 16², where the last
  stages see 1 x 1 maps (4 values a channel), so the biased and unbiased
  batch variances differ by 4/3: the logits and the updated
  ``batch_stats`` equal JAX's (rtol 1e-4, atol 1e-5), and a control with
  ``nn.BatchNorm2d`` (torch's momentum 0.1 = flax's 0.9, but the unbiased
  variance in its running update) misses that tolerance;
- ``convert_torch_resnet18`` equal to JAX's converter on the same
  torchvision-layout state dict, and the converted backbone equal to the
  torch model's eval features.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from emr2a_tpu.models import resnet as jr
from emr2a_tpu.models.convert import convert_torch_resnet18 as jax_convert
from emr2a_tpu_torch.models import resnet as pr
from emr2a_tpu_torch.models.convert import convert_torch_resnet18, resnet_from_jax
from emr2a_tpu_torch.tools.torchvision_resnet import torchvision_resnet18

EVAL_TOL = dict(atol=2e-4, rtol=1e-3)
STATS_TOL = dict(atol=1e-5, rtol=1e-4)


def _randomized(variables, rng):
    """JAX variables with every BatchNorm's scale, bias, mean and var drawn
    at random (flax's init leaves them 1 / 0 / 0 / 1)."""
    def draw(path, a):
        leaf = jax.tree_util.keystr(path[-1:])
        if "scale" in leaf or "var" in leaf:
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if "mean" in leaf or ("bias" in leaf and "bn" in jax.tree_util.keystr(path)):
            return rng.normal(0, 0.1, a.shape).astype(np.float32)
        return np.asarray(a)
    return jax.tree_util.tree_map_with_path(draw, dict(variables))


def _jax_init(model, *shapes):
    return jax.tree_util.tree_map(np.asarray, dict(model.init(
        jax.random.PRNGKey(0), *(jnp.zeros(s) for s in shapes), train=False)))


def _port(cls, variables, **kw):
    m = cls(**kw)
    m.load_state_dict(resnet_from_jax(variables))      # strict: every name maps
    return m


@pytest.mark.parametrize("which", ["backbone", "image_only", "multimodal"])
def test_eval_forward_matches_jax(which, rng):
    x = rng.randn(2, 2, 32, 32, 3).astype(np.float32)
    clin = rng.randn(2, 3).astype(np.float32)
    if which == "backbone":
        variables = _randomized(_jax_init(jr.ResNet18(), (1, 32, 32, 3)), rng)
        want = jr.ResNet18().apply(variables, jnp.asarray(x[:, 0]), train=False)
        got = _port(pr.ResNet18, variables).eval()(torch.from_numpy(x[:, 0]))
    elif which == "image_only":
        variables = _randomized(_jax_init(jr.ImageOnlyModel(), (1, 2, 32, 32, 3)), rng)
        want = jr.ImageOnlyModel().apply(variables, jnp.asarray(x), train=False)
        got = _port(pr.ImageOnlyModel, variables).eval()(torch.from_numpy(x))
    else:
        variables = _randomized(_jax_init(jr.MultimodalModel(), (1, 2, 32, 32, 3),
                                          (1, 3)), rng)
        want = jr.MultimodalModel().apply(variables, jnp.asarray(x), jnp.asarray(clin),
                                          train=False)
        got = _port(pr.MultimodalModel, variables).eval()(torch.from_numpy(x),
                                                          torch.from_numpy(clin))
    want = np.asarray(want)
    assert np.abs(want).max() > 1e-3          # not a dead (all-zero) forward
    np.testing.assert_allclose(got.detach().numpy(), want, **EVAL_TOL)


def _torch_bn_control(model: nn.Module) -> nn.Module:
    """``model`` with every flax-style BatchNorm replaced by an
    ``nn.BatchNorm2d`` holding the same parameters and statistics."""
    model = copy.deepcopy(model)
    for name, sub in list(model.named_modules()):
        if isinstance(sub, pr.BatchNorm):
            bn = nn.BatchNorm2d(sub.weight.numel(), eps=sub.eps, momentum=1 - sub.momentum)
            bn.load_state_dict(sub.state_dict(), strict=False)
            parent, _, leaf = name.rpartition(".")
            setattr(model.get_submodule(parent), leaf, bn)
    return model


def test_train_mode_batch_stats_follow_flax(rng):
    x = rng.randn(2, 2, 16, 16, 3).astype(np.float32)
    variables = _randomized(_jax_init(jr.ImageOnlyModel(), (1, 2, 16, 16, 3)), rng)
    logits, upd = jr.ImageOnlyModel().apply(variables, jnp.asarray(x), train=True,
                                            mutable=["batch_stats"])
    want = resnet_from_jax({"params": {}, "batch_stats": jax.tree_util.tree_map(
        np.asarray, upd["batch_stats"])})

    port = _port(pr.ImageOnlyModel, variables)
    control = _torch_bn_control(port)
    got = port.train()(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(logits), **EVAL_TOL)
    state = port.state_dict()
    for name, value in want.items():
        np.testing.assert_allclose(state[name].numpy(), value.numpy(), **STATS_TOL,
                                   err_msg=name)

    control.train()(torch.from_numpy(x))
    ctrl = control.state_dict()
    var_names = [n for n in want if n.endswith("running_var")]
    misses = [n for n in var_names
              if not np.allclose(ctrl[n].numpy(), want[n].numpy(), **STATS_TOL)]
    # the 1 x 1 maps of the last stage: var x 4/3 in torch's update
    assert "backbone.stage3_block1.bn2.running_var" in misses, misses
    assert len(misses) >= len(var_names) // 2, (len(misses), len(var_names))
    for n in want:                        # the means agree: only the var differs
        if n.endswith("running_mean"):
            np.testing.assert_allclose(ctrl[n].numpy(), want[n].numpy(), **STATS_TOL)


def test_convert_torch_resnet18_matches_jax_and_torch(rng):
    model = torchvision_resnet18(seed=0)
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    got = convert_torch_resnet18(sd)
    want = resnet_from_jax(jax_convert(sd))
    assert sorted(got) == sorted(want)
    assert not any(k.startswith("fc") or "num_batches" in k for k in got)
    for k in got:
        assert torch.equal(got[k], want[k]), k

    backbone = pr.ResNet18()
    backbone.load_state_dict(got)
    x = rng.randn(2, 64, 64, 3).astype(np.float32)
    with torch.no_grad():
        expected = model(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
        out = backbone.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, expected, **EVAL_TOL)
    jax_out = jr.ResNet18().apply(jax_convert(sd), jnp.asarray(x), train=False)
    np.testing.assert_allclose(out, np.asarray(jax_out), **EVAL_TOL)


def test_random_init_is_seeded():
    a, b, c = pr.ImageOnlyModel(seed=0), pr.ImageOnlyModel(seed=0), pr.ImageOnlyModel(seed=1)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["backbone.stem_conv.weight"], sc["backbone.stem_conv.weight"])
    assert torch.equal(sa["backbone.stem_bn.weight"], torch.ones(64))
    w = sa["backbone.stage1_block0.conv1.weight"]
    np.testing.assert_allclose(float(w.std()), (64 * 9) ** -0.5, rtol=0.05)
