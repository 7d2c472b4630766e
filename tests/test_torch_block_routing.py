"""``models/layers.TransformerBlock``'s routing against the JAX package's:
with ``fused_attn`` / ``fused_mlp`` set, each half takes its fused op only
where the reference's rule admits the shape (``pick_fused_attn_params``;
the fused MLP's residency rule), else the unfused path (erf gelu, the
``valid_len`` key mask). Blocks run in f32 on the CPU at the ViT tests'
tolerance (atol = rtol = 1e-4), with the JAX block's params carried across
by ``params_from_jax``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emr2a_tpu.models.layers import TransformerBlock as JaxBlock
from emr2a_tpu.ops import attention_block as jax_attn
from emr2a_tpu_torch.models import layers
from emr2a_tpu_torch.models.convert import params_from_jax
from emr2a_tpu_torch.ops import attention_block as port_attn

torch.set_num_threads(1)


def _refuse(name):
    def fail(*args, **kwargs):
        raise AssertionError(f"{name} was called where the rule refuses it")
    return fail


def _block_pair(d, heads, mlp, x):
    jblock = JaxBlock(num_heads=heads, mlp_dim=mlp, fused_attn=True, fused_mlp=True)
    params = jblock.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    pblock = layers.TransformerBlock(d, heads, mlp, fused_attn=True, fused_mlp=True)
    pblock.load_state_dict(params_from_jax(params))
    return jblock, params, pblock


@pytest.mark.parametrize("S,attn_fused,mlp_fused", [
    (8, True, False),      # ViT-L width: the 1024 x 4096 MLP over the rule
    (577, False, False),   # ViT-L/336: the attention over the rule as well
])
def test_vit_l_block_routes_as_jax(rng, monkeypatch, S, attn_fused, mlp_fused):
    d, heads, mlp = 1024, 16, 4096
    x = (rng.randn(1, S, d) * 0.5).astype(np.float32)
    jblock, params, pblock = _block_pair(d, heads, mlp, x)
    assert (jax_attn.pick_fused_attn_params(d, S, heads) is not None) == attn_fused
    assert (port_attn.pick_fused_attn_params(d, S, heads) is not None) == attn_fused
    assert layers.fused_mlp_fits(d, mlp, 2) == mlp_fused
    monkeypatch.setattr(layers, "fused_ln_mlp", _refuse("fused_ln_mlp"))
    if not attn_fused:
        monkeypatch.setattr(layers, "fused_ln_attention", _refuse("fused_ln_attention"))
    want = np.asarray(jblock.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = pblock(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_unfused_attention_masks_keys_past_valid_len(rng, monkeypatch):
    """S = 577 with valid_len 570: the unfused attention masks the pad keys,
    as JAX's block does with its ``valid_len`` attribute."""
    d, heads, mlp, S, valid = 1024, 16, 256, 577, 570
    x = (rng.randn(1, S, d) * 0.5).astype(np.float32)
    jblock = JaxBlock(num_heads=heads, mlp_dim=mlp, fused_attn=True, fused_mlp=True,
                      valid_len=valid)
    params = jblock.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    pblock = layers.TransformerBlock(d, heads, mlp, fused_attn=True, fused_mlp=True)
    pblock.load_state_dict(params_from_jax(params))
    monkeypatch.setattr(layers, "fused_ln_attention", _refuse("fused_ln_attention"))
    want = np.asarray(jblock.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = pblock(torch.from_numpy(x), valid_len=valid).numpy()
    np.testing.assert_allclose(got[:, :valid], want[:, :valid], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("d,S,heads,w8", [
    (768, 197, 12, False), (768, 200, 12, False), (768, 200, 12, True),
    (1024, 257, 16, False), (1024, 257, 16, True), (1024, 577, 16, True),
    (768, 577, 12, False), (384, 1025, 6, False), (64, 17, 2, False),
])
def test_attention_rule_equals_jax(d, S, heads, w8):
    """The port's copy of the VMEM rule returns JAX's configuration; ViT-B
    (d = 768, S = 197/200, bf16 and int8) is admitted."""
    itemsize = 1 if w8 else 2
    want = jax_attn.pick_fused_attn_params(d, S, heads, weight_itemsize=itemsize)
    assert port_attn.pick_fused_attn_params(d, S, heads, weight_itemsize=itemsize) == want
    for hg, bb in ((1, 1), (6, 4), (4, 2)):
        assert port_attn.fused_attn_vmem_bytes(d, S, heads, hg, bb, weight_itemsize=itemsize) \
            == jax_attn.fused_attn_vmem_bytes(d, S, heads, hg, bb, weight_itemsize=itemsize)
    if d == 768 and S <= 200:
        assert want is not None and layers.fused_mlp_fits(768, 3072, itemsize)


def test_vit_b_block_still_takes_the_fused_ops(rng, monkeypatch):
    """At ViT-B width both halves pass the rule: the port calls the fused
    ops (their plain versions on the CPU), as JAX calls its kernels."""
    calls = []
    for name in ("fused_ln_attention", "fused_ln_mlp"):
        real = getattr(layers, name)
        monkeypatch.setattr(layers, name,
                            lambda *a, _r=real, _n=name, **k: calls.append(_n) or _r(*a, **k))
    block = layers.TransformerBlock(768, 12, 3072, fused_attn=True, fused_mlp=True)
    with torch.no_grad():
        block(torch.zeros(1, 8, 768), valid_len=5)
    assert calls == ["fused_ln_attention", "fused_ln_mlp"]
