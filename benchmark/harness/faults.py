"""Faults planted in the program's timed path, to show that the comparison
catches them (benchmark/tests and calibrate.py; a benchmark run plants
none).  Each is a context manager that patches the program's module
attribute the entries call:

  unchanged   the optimizer's update does nothing, so a step returns its
              state unchanged (training);
  half_batch  the step sees half of its batch and takes its mean over
              that half (training), or the predictor computes the first
              half of a batch and repeats it for the rest (leaderboard);
  altered     the predictor's answers for a batch's first two frames are
              swapped where they are produced (leaderboard);
  shifted     the warp's views come out moved by one pixel along their
              rows, where the warp produces them (training);
  flipped     the optimizer's update goes the other way: each parameter
              moves by the step's change with its sign turned
              (fine-tuning; in pretraining bf16 rounding turns the
              update's direction as far, PERF.md);
  turned      the inverse rotation in projection space turns the wrong
              way, where the equivariant transform produces it
              (pretraining).
"""

from __future__ import annotations

import contextlib

import torch

FAULTS = {"pretrain": ("unchanged", "half_batch", "shifted", "turned"),
          "finetune": ("unchanged", "half_batch", "shifted", "flipped"),
          "pred": ("half_batch", "altered")}


@contextlib.contextmanager
def _patched(module, name, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def _half(batch):
    n = next(iter(batch.values())).shape[0]
    return {k: v[: n // 2] for k, v in batch.items()}


@contextlib.contextmanager
def plant(kind: str, fault: str):
    if fault is None:
        yield
        return
    if fault not in FAULTS[kind]:
        raise ValueError(f"{kind} cells have no fault {fault!r}")
    if fault == "unchanged":
        from peclr_tpu_torch.train import optimizer

        def no_update(self, closure=None):
            return None

        with _patched(optimizer.PretrainOptimizer, "step", no_update):
            yield
    elif fault == "flipped":
        from peclr_tpu_torch.train import optimizer

        step = optimizer.PretrainOptimizer.step

        def flipped(self, closure=None):
            params = [p for g in self.param_groups for p in g["params"]]
            before = [p.detach().clone() for p in params]
            step(self, closure)
            with torch.no_grad():
                for p, b in zip(params, before):
                    p.copy_(2 * b - p)

        with _patched(optimizer.PretrainOptimizer, "step", flipped):
            yield
    elif fault == "shifted":
        from peclr_tpu_torch.ops import augment

        warp = augment.affine_warp_mxu

        def shifted(*a, **kw):
            return torch.roll(warp(*a, **kw), 1, dims=-2)

        with _patched(augment, "affine_warp_mxu", shifted):
            yield
    elif fault == "turned":
        from peclr_tpu_torch.train import step as step_mod

        project = step_mod.peclr_projections

        def turned(proj1, proj2, params1, params2, **kw):
            return project(proj1, proj2, {**params1, "angle": -params1["angle"]},
                           {**params2, "angle": -params2["angle"]}, **kw)

        with _patched(step_mod, "peclr_projections", turned):
            yield
    elif kind == "pretrain":
        from peclr_tpu_torch.train import step as step_mod

        make = step_mod.make_peclr_train_step

        def half_step(model, opt, flags, params, accum=1, **kw):
            inner = make(model, opt, flags, params, accum=max(accum // 2, 1),
                         **kw)
            return lambda state, batch, gen, draws=None: inner(
                state, _half(batch), gen)

        with _patched(step_mod, "make_peclr_train_step", half_step):
            yield
    elif kind == "finetune":
        from peclr_tpu_torch.train import finetune

        make = finetune.make_finetune_step

        def half_step(*args, **kw):
            inner = make(*args, **kw)
            return lambda state, batch, gen, draws=None: inner(
                state, _half(batch), gen)

        with _patched(finetune, "make_finetune_step", half_step):
            yield
    else:
        from peclr_tpu_torch.eval import pred_fh

        run = pred_fh.run_two_pass

        def broken(model, images, K, *a, **kw):
            if fault == "half_batch":
                h = images.shape[0] // 2
                out = run(model, images[:h], K[:h], *a, **kw)
                reps = -(-images.shape[0] // h)
                return {k: v.repeat(reps, *([1] * (v.dim() - 1)))[
                    : images.shape[0]] for k, v in out.items()}
            out = run(model, images, K, *a, **kw)
            kp3d = out["kp3d"].clone()
            kp3d[[0, 1]] = kp3d[[1, 0]]
            return {**out, "kp3d": kp3d}

        with _patched(pred_fh, "run_two_pass", broken):
            yield

