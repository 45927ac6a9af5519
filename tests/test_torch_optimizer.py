"""The port's optimizer (peclr_tpu_torch/train/optimizer.py) against the
reference's optax chain on the CPU: the schedule, the no-decay mask leaf by
leaf, and several LARS+Adam updates."""

import jax.numpy as jnp
import numpy as np
import optax
import torch
from torch import nn

from peclr_tpu.train import optimizer as jax_opt
from peclr_tpu_torch.data.synthetic import seeded_peclr_variables
from peclr_tpu_torch.models import PeCLRModel
from peclr_tpu_torch.models.port import flatten, peclr_mapping
from peclr_tpu_torch.train import optimizer


def test_schedule_matches_optax():
    """f64 on the host against optax's f32: 1e-6 relative."""
    for peak, warmup, total, end in ((2.8e-3, 625, 6250, 0.0),
                                     (1.0, 2, 4, 0.0), (0.5, 1, 1, 0.1)):
        got = optimizer.warmup_cosine(peak, warmup, total, end)
        ref = jax_opt.warmup_cosine(peak, warmup, total, end)
        for count in (0, 1, 2, 3, warmup - 1, warmup, warmup + 1, total - 1,
                      total, total + 5):
            np.testing.assert_allclose(got(count), float(ref(count)),
                                       rtol=1e-6, atol=1e-9,
                                       err_msg=f"{peak} {count}")
    assert optimizer.scaled_lr(1e-4, 128, 16) == jax_opt.scaled_lr(1e-4, 128,
                                                                   16)


def test_no_decay_mask_matches_leaf_by_leaf():
    """By module type in the port, by flax path in the reference: every
    BatchNorm parameter (downsample and head included) and every bias is
    left undecayed, the conv and dense kernels are decayed."""
    variables = seeded_peclr_variables("18", seed=0)
    ref = {"/".join(k): v for k, v in
           flatten(jax_opt.no_decay_mask(variables["params"])).items()}
    mask = optimizer.no_decay_mask(PeCLRModel("18"))
    params = [(t, p) for t, coll, p, _ in peclr_mapping("18")
              if coll == "params"]
    assert len(mask) == len(params) == len(ref)
    for torch_name, path in params:
        assert mask[torch_name] == ref["/".join(path)], torch_name
    assert not mask["encoder.features.5.0.downsample.1.weight"]
    assert not mask["projection_head.1.weight"]
    assert mask["encoder.features.5.0.downsample.0.weight"]


class _Tiny(nn.Module):
    """conv1 (decayed), bn1 (not), fc.weight (decayed), fc.bias (not)."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 4, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(4)
        self.fc = nn.Linear(4, 5)


def _flax_tree(model):
    """The same values under flax names (the reference masks by name)."""
    p = {n: v.detach().numpy().copy() for n, v in model.named_parameters()}
    return {"conv1": {"kernel": jnp.asarray(p["conv1.weight"])},
            "bn1": {"scale": jnp.asarray(p["bn1.weight"]),
                    "bias": jnp.asarray(p["bn1.bias"])},
            "fc": {"kernel": jnp.asarray(p["fc.weight"]),
                   "bias": jnp.asarray(p["fc.bias"])}}


_NAMES = {"conv1.weight": ("conv1", "kernel"), "bn1.weight": ("bn1", "scale"),
          "bn1.bias": ("bn1", "bias"), "fc.weight": ("fc", "kernel"),
          "fc.bias": ("fc", "bias")}


def test_updates_match_optax(rng):
    """Six updates with the same gradients: a warmup that starts at lr 0
    (so the first update moves nothing), a weight decay large enough for
    the mask to matter, one zero gradient (LARS's trust ratio falls back to
    1).  Parameters agree after every update to 1e-5 of the largest step
    (peak lr 0.14 times Adam's normalised update, about 1): the schedule is
    taken in f64 here and in f32 by optax."""
    torch.manual_seed(0)
    model = _Tiny()
    with torch.no_grad():
        model.bn1.weight.uniform_(0.5, 1.5)
        model.bn1.bias.normal_()
    tree = _flax_tree(model)
    kw = dict(base_lr=0.05, batch_size=4, accum=2, steps_per_epoch=6,
              epochs=3, warmup_epochs=1, weight_decay=0.3)
    tx, _ = jax_opt.build_optimizer(tree, optimizer="LARS", **kw)
    opt_state = tx.init(tree)
    opt, _ = optimizer.build_optimizer(model, **kw)
    params = dict(model.named_parameters())
    for step in range(6):
        grads = {n: rng.normal(size=p.shape).astype(np.float32)
                 for n, p in params.items()}
        if step == 2:
            grads["fc.bias"][:] = 0.0
        for n, p in params.items():
            p.grad = torch.from_numpy(grads[n])
        opt.step()
        g_tree = {a: {} for a in tree}
        for n, (a, b) in _NAMES.items():
            g_tree[a][b] = jnp.asarray(grads[n])
        updates, opt_state = tx.update(g_tree, opt_state, tree)
        tree = optax.apply_updates(tree, updates)
        for n, (a, b) in _NAMES.items():
            np.testing.assert_allclose(params[n].detach().numpy(),
                                       np.asarray(tree[a][b]), rtol=1e-5,
                                       atol=2e-6, err_msg=f"{n} step {step}")
    assert opt.count == 6


def test_first_update_moves_nothing(rng):
    model = _Tiny()
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt, _ = optimizer.build_optimizer(model, 1e-3, 4, 2, steps_per_epoch=4,
                                       epochs=2, warmup_epochs=1)
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    for n, p in model.named_parameters():
        assert torch.equal(p, before[n]), n
    state = opt.state_dict()
    assert state["count"] == 1
    again, _ = optimizer.build_optimizer(model, 1e-3, 4, 2, steps_per_epoch=4,
                                         epochs=2, warmup_epochs=1)
    again.load_state_dict(state)
    assert again.count == 1
