"""Port preprocessing against ``emr2a_tpu.ops.preprocess`` on inputs that
need no resize (the only inputs the step2 engine hands it)."""

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


def test_device_resize_is_not_ported(rng):
    images = torch.zeros((1, 300, 300, 3), dtype=torch.uint8)
    with pytest.raises(NotImplementedError, match="resize"):
        port_pre.preprocess_images(images, port_pre.BIOMEDCLIP_PREPROCESS)


@pytest.mark.parametrize("n,k,mode", [(40, 4, "uniform"), (41, 4, "random"),
                                      (3, 4, "uniform"), (3, 4, "random"),
                                      (10, 3, "uniform"), (100, 7, "random")])
def test_sample_slice_indices_matches_jax(n, k, mode):
    assert port_pre.sample_slice_indices(n, k, mode) == \
        jax_pre.sample_slice_indices(n, k, mode)
    with pytest.raises(ValueError, match="Unknown sampling"):
        port_pre.sample_slice_indices(n + 5, k, "every_other")
