"""The port's PeCLR pretrain step with all ten augmentation flags the CLI
takes (the recipe's and sobel, cut-out, blur, noise, colour drop) against
the reference's jitted step: two RN18 steps at the dry-run shape, f32 on the
CPU, as tests/test_torch_train_step.py runs the recipe's flags, with its
bounds and for the same reasons (its docstring).

The port is handed the parameters the reference drew and, for the flags
outside the recipe, the draws its augment_pair makes from each
microbatch's key (tests/test_torch_augment.py:_replayed_draws).  The
reference computes its views op by op, as in that file.

The views: the Sobel filter, the blur and the warp of their float output sum
in another order than XLA's, so one value in ~10^5 of the port's views
lands a colour-jitter floor away from the reference's (a few units of
0-255); at these seeds 3 of 98,304 values of one view do, and they move the
tiny RN18's first-conv gradient by 1.8%.  So the port's step computes its
views, holds them to the reference's at tests/test_torch_augment.py's image
tolerance, and trains on the reference's (op_by_op_runs' share_views);
the step's draws, apply's parameters and everything after the views are
the port's own.
"""

import pytest

from peclr_tpu.config.defaults import AugmentationFlags as JaxFlags
from peclr_tpu_torch.config.defaults import AugmentationFlags
from tests.test_torch_augment import _all_flags, _replayed_draws
from tests.test_torch_train_step import (
    check_batch_stats,
    check_grads,
    check_loss,
    check_params_after_each_update,
    check_projection_stats,
    op_by_op_runs,
)


@pytest.fixture(scope="module")
def runs():
    return op_by_op_runs(_all_flags(JaxFlags), _all_flags(AugmentationFlags),
                         _replayed_draws, share_views=True)


@pytest.mark.parametrize("s", [0, 1])
def test_all_flags_loss_matches(runs, s):
    check_loss(runs, s)


@pytest.mark.parametrize("s", [0, 1])
def test_all_flags_grads_match(runs, s):
    check_grads(runs, s)


@pytest.mark.parametrize("s", [0, 1])
def test_all_flags_batch_stats_match(runs, s):
    check_batch_stats(runs, s)


def test_all_flags_params_after_each_update(runs):
    check_params_after_each_update(runs)


def test_all_flags_projection_stats_match(runs):
    check_projection_stats(runs)
