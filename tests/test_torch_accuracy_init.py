"""The accuracy scripts' initial weights (peclr_tpu_torch/scripts/__init__.py
:init_as_reference) against the reference's `PeCLRModel.init` (flax's
default initialisers), parameter by parameter, on the CPU.

The numbers differ (torch's generator is not jax.random's); what must agree
is each tensor's distribution: every parameter and statistic the flax model
has, of the same shape; the constant ones (biases, BatchNorm scale, bias,
running mean and variance) equal; each drawn weight's mean, standard
deviation and largest magnitude those of a normal truncated at 2 standard
deviations, within the sampling error of its size.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from peclr_tpu.models import PeCLRModel as JaxPeCLR
from peclr_tpu_torch.models import PeCLRModel
from peclr_tpu_torch.models.port import peclr_variables_to_state_dict
from peclr_tpu_torch.scripts import init_as_reference

#: sample standard deviations within this many standard errors of each other
STD_ERRORS = 6.0
#: the standard deviation of a unit normal truncated at +-2
TRUNC_STD = 0.87962566103423978


def _both(size, seed):
    variables = JaxPeCLR(resnet_size=size, dtype=jnp.bfloat16).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 64, 64, 3)), train=False)
    want = peclr_variables_to_state_dict(variables, size)
    got = init_as_reference(PeCLRModel(size), seed).state_dict()
    # torch's BatchNorm step counter has no flax counterpart
    return ({k: v.numpy() for k, v in d.items()
             if not k.endswith("num_batches_tracked")} for d in (got, want))


@pytest.mark.parametrize("size", ["18", "50", "152"])
def test_initial_weights_have_the_reference_distributions(size):
    got, want = _both(size, seed=5)
    assert sorted(got) == sorted(want)
    drawn = 0
    for key in want:
        g, w = got[key], want[key].astype(np.float32)
        assert g.shape == w.shape, key
        if np.all(w == w.flat[0]):
            # a constant of the flax init: zero biases, BatchNorm 1 / 0
            np.testing.assert_array_equal(g, w, err_msg=key)
            continue
        drawn += 1
        n = w.size
        assert abs(g.std() / w.std() - 1.0) < STD_ERRORS / np.sqrt(2 * n), (
            key, g.std(), w.std())
        mean_tol = 2 * STD_ERRORS * w.std() / np.sqrt(n)
        assert abs(g.mean() - w.mean()) < mean_tol, (key, g.mean(), w.mean())
        # cut at 2 standard deviations of the normal before truncation
        bound = 2.0 * w.std() / TRUNC_STD * (1.0 + STD_ERRORS / np.sqrt(2 * n))
        assert np.abs(g).max() <= bound and np.abs(w).max() <= bound, key
    # the drawn tensors are the convolutions' and dense layers' weights
    assert drawn == sum(1 for v in want.values() if v.ndim > 1), drawn
