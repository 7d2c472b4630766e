"""Port ``cosine_topk`` / ``topk_scores`` against ``emr2a_tpu.ops.topk``,
with exact ties, which must go to the lowest index as in
``jax.lax.top_k``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emr2a_tpu.ops import topk as jax_topk
from emr2a_tpu_torch.ops import topk as port_topk

torch.set_num_threads(1)


@pytest.mark.parametrize("normalize", [True, False])
def test_cosine_topk_matches_jax_with_ties(rng, normalize):
    db = rng.randn(40, 16).astype(np.float32)
    db[[7, 21, 33]] = db[3]            # four identical rows
    db[[12, 30]] = db[5] * 2.0         # same direction, other norm
    queries = np.concatenate([db[[3, 5]], rng.randn(3, 16)]).astype(np.float32)
    want_v, want_i = jax_topk.cosine_topk(jnp.asarray(queries), jnp.asarray(db),
                                          k=6, normalize=normalize)
    got_v, got_i = port_topk.cosine_topk(torch.from_numpy(queries),
                                         torch.from_numpy(db), k=6,
                                         normalize=normalize)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), atol=1e-6)


def test_topk_scores_ties_go_to_lowest_index():
    scores = np.array([[1.0, 3.0, 3.0, 2.0, 3.0, 0.0],
                       [5.0, 5.0, 5.0, 5.0, 5.0, 5.0]], np.float32)
    want_v, want_i = jax_topk.topk_scores(jnp.asarray(scores), 4)
    got_v, got_i = port_topk.topk_scores(torch.from_numpy(scores), 4)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_i.numpy(), [[1, 2, 4, 3], [0, 1, 2, 3]])
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
