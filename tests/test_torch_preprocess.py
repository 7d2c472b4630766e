"""Port preprocessing against ``emr2a_tpu.ops.preprocess``: inputs that
need no resize (the only inputs the step2 engine hands it), and the device
resize (``jax.image.resize(..., antialias=True)``) when downscaling,
upscaling and resizing exactly, bicubic and bilinear."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emr2a_tpu.ops import preprocess as jax_pre
from emr2a_tpu_torch.ops import preprocess as port_pre

torch.set_num_threads(1)


def test_biomedclip_spec_matches_jax():
    assert (dataclasses.asdict(port_pre.BIOMEDCLIP_PREPROCESS)
            == dataclasses.asdict(jax_pre.BIOMEDCLIP_PREPROCESS))
    assert ([f.name for f in dataclasses.fields(port_pre.PreprocessSpec)]
            == [f.name for f in dataclasses.fields(jax_pre.PreprocessSpec)])


@pytest.mark.parametrize("h,w,resize", [
    (224, 224, 224),     # identity plan, no crop
    (256, 256, 256),     # identity plan, centre crop 16 px each side
    (224, 300, 224),     # shortest edge already 224: crop the long side
])
def test_preprocess_matches_jax(rng, h, w, resize):
    fields = dict(resize_size=resize)
    jax_spec = jax_pre.PreprocessSpec(**fields)
    port_spec = port_pre.PreprocessSpec(**fields)
    images = (rng.rand(2, h, w, 3) * 255).astype(np.uint8)
    want = np.asarray(jax_pre.preprocess_images(jnp.asarray(images), jax_spec))
    got = port_pre.preprocess_images(torch.from_numpy(images), port_spec)
    assert got.dtype == torch.float32 and got.shape == (2, 224, 224, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


@pytest.mark.parametrize("h,w,fields", [
    (300, 400, dict()),                                      # downscale, bicubic
    (150, 150, dict()),                                      # upscale, bicubic
    (300, 260, dict(shortest_edge=False, method="bilinear")),  # exact, bilinear
    (180, 333, dict(shortest_edge=False)),                   # exact, bicubic
])
def test_device_resize_matches_jax(rng, h, w, fields):
    """The device resize against ``jax.image.resize(antialias=True)``
    through JAX's ``preprocess_images``, within 2e-5 in pixel units (the
    outputs times the spec's std). The port's weight matrices equal JAX's
    eager ones within 1e-7 (the test below); under ``jit`` XLA reassociates
    the f32 sample positions (an ulp of 3e-5 at 300 pixels), which moves
    JAX's own weights by up to 1.1e-5."""
    jax_spec = jax_pre.PreprocessSpec(**fields)
    port_spec = port_pre.PreprocessSpec(**fields)
    images = (rng.rand(2, h, w, 3) * 255).astype(np.uint8)
    want = np.asarray(jax_pre.preprocess_images(jnp.asarray(images), jax_spec))
    got = port_pre.preprocess_images(torch.from_numpy(images), port_spec)
    assert got.dtype == torch.float32 and got.shape == want.shape == (2, 224, 224, 3)
    std = np.asarray(port_spec.std, np.float32)
    np.testing.assert_allclose(got.numpy() * std, want * std, rtol=0, atol=2e-5)


@pytest.mark.parametrize("n_in,n_out", [(300, 224), (150, 224), (7, 3), (224, 224)])
@pytest.mark.parametrize("method", ["bicubic", "bilinear"])
def test_resize_weights_match_jax(n_in, n_out, method):
    """One axis's weight matrix against JAX's eager ``compute_weight_mat``
    (f32, within 1e-6)."""
    from jax._src.image.scale import _kernels, compute_weight_mat
    import jax.image
    kind = jax.image.ResizeMethod.CUBIC if method == "bicubic" else jax.image.ResizeMethod.LINEAR
    want = compute_weight_mat(n_in, n_out, n_out / n_in, 0.0, _kernels[kind], True)
    got = port_pre.resize_weights(n_in, n_out, method)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


@pytest.mark.parametrize("n,k,mode", [(40, 4, "uniform"), (41, 4, "random"),
                                      (3, 4, "uniform"), (3, 4, "random"),
                                      (10, 3, "uniform"), (100, 7, "random")])
def test_sample_slice_indices_matches_jax(n, k, mode):
    assert port_pre.sample_slice_indices(n, k, mode) == \
        jax_pre.sample_slice_indices(n, k, mode)
    with pytest.raises(ValueError, match="Unknown sampling"):
        port_pre.sample_slice_indices(n + 5, k, "every_other")
