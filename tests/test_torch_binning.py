"""ops/binning.py's counting sort against the JAX package's
(tests/test_binning.py's cases on the port) and against
torch.sort(stable=True), which the renderer's class_order uses: the same
permutation and its inverse, over leading dims."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dist_renderer_tpu.ops.binning import counting_sort_perm as jcounting_sort_perm
from dist_renderer_tpu_torch.ops.binning import counting_sort_perm
from dist_renderer_tpu_torch.ops.renderer import class_order
from test_torch_grad import one_thread  # noqa: F401 (autouse: torch on one thread)


@pytest.mark.parametrize("shape,classes", [((3, 1000), 5), ((2, 3, 257), 3), ((512,), 3)])
def test_counting_sort_matches_jax_and_stable_sort(shape, classes):
    key = np.random.default_rng(0).integers(0, classes, shape).astype(np.int32)
    order, inv = counting_sort_perm(torch.as_tensor(key), classes)
    jorder, jinv = jcounting_sort_perm(jnp.asarray(key), classes)
    np.testing.assert_array_equal(order.numpy(), np.asarray(jorder))
    np.testing.assert_array_equal(inv.numpy(), np.asarray(jinv))
    ref = torch.sort(torch.as_tensor(key), dim=-1, stable=True).indices
    assert torch.equal(order, ref)
    # inv unsorts: sorted[inv] == x
    x = torch.as_tensor(np.random.default_rng(1).standard_normal(shape))
    s = torch.gather(x, -1, order)
    assert torch.equal(torch.gather(s, -1, inv), x)
    if len(shape) == 1:
        assert all(torch.equal(a, b) for a, b in zip(class_order(torch.as_tensor(key)),
                                                     (order, inv)))


def test_counting_sort_one_dim_and_degenerate():
    key = torch.zeros((64,), dtype=torch.int32)  # all one class
    order, inv = counting_sort_perm(key, 3)
    assert torch.equal(order, torch.arange(64)) and torch.equal(inv, torch.arange(64))
    order, inv = counting_sort_perm(torch.full((5,), 2), 3)  # only the last class
    assert torch.equal(order, torch.arange(5)) and torch.equal(inv, torch.arange(5))
