"""The numbers that decide `correct`, each against its limit.

Training (the pretrain and fine-tune cells) compares the program's first
steps from the seeded start, taken once the window has closed through the
window's own model, optimizer, call and feed (rewound in place), with the
reference's from the same weights, inputs and draws:
  * loss_gap: the largest |loss - reference loss| / |reference loss| over
    the steps;
  * grad_gap: the worst leaf's |‖g‖ - ‖g_ref‖| / max(‖g_ref‖, the median
    leaf's ‖g_ref‖), g being the first gradient as the optimizer gets it
    (g + wd p; the program's worked out from its Adam state after one
    step, mu / (1 - b1));
  * change_gap: the same of the parameters' change over the steps, leaving
    out leaves whose reference gradient is under a thousandth of the
    median leaf's (they move by round-off alone under Adam);
  * grad_gap_median: the median leaf's grad gap, steady where the worst
    leaf is not (the pretrain cells, PERF.md);
  * stats_gap: the worst BatchNorm running statistic after the steps,
    ‖program - reference‖ / ‖reference‖;
  * view_gap: the model's input in the first step's first microbatch (the
    augmented views: the warp's kernel, colour and normalisation) against
    the reference's, as pass1_gap below reads keypoints (per channel);
  * proj_gap (pretraining): that microbatch's projections, ‖program -
    reference‖ / ‖reference‖ (read for the look in PERF.md, not compared);
  * ntxent_gap (pretraining): the first step's loss against the
    reference's inverse transforms and NT-Xent of the program's own
    projections, |loss - staged| / |staged|.
Each cell compares the numbers its workload file gives limits for.
The leaderboard predictor compares a sample of the window's answers stage
by stage with the reference (pass 1 from the frames; the refined affine
from the program's pass-1 keypoints; pass 2 on the program's affine):
  * pass1_gap: the largest |kp25d - reference| over the sample, per
    coordinate (u, v, relative depth) as a share of the largest reference
    magnitude of that coordinate;
  * pass2_gap: the same for the refined affine's six entries and the final
    kp3d's three coordinates, the larger of the two.
Every cell also compares what a run on the card watched of the dispatch
(DISPATCH_LIMITS): host_waits, the waits on the card in the watched steps
or batch, and launch_gap, the largest distance of the warp kernels'
launches a unit from those due.  A reading that is not finite fails.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

#: limits of the dispatch readings, the same in every cell: no wait on the
#: card inside a step or batch, and the warp's launches exactly as due
DISPATCH_LIMITS = {"host_waits": 0, "launch_gap": 0}


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.detach().double()))


def _median(values: List[float]) -> float:
    s = sorted(values)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def _leaf_gaps(run: dict, ref: dict, start: Dict[str, torch.Tensor]):
    """Per leaf: the gap of the first gradients' norms, and (for the leaves
    the rule keeps) the gap of the changes' norms, each over the larger of
    the reference's norm and the median leaf's, with the norms."""
    names = sorted(ref["first_grad"])
    g_ref = {n: _norm(ref["first_grad"][n]) for n in names}
    g_run = {n: _norm(run["first_grad"][n]) for n in names}
    med_g = _median(list(g_ref.values()))
    kept = [n for n in names if g_ref[n] >= 1e-3 * med_g]
    d_ref = {n: _norm(ref["params"][n].double()
                      - start[n].double().to(ref["params"][n].device))
             for n in kept}
    d_run = {n: _norm(run["params"][n].double().to(start[n].device)
                      - start[n].double()) for n in kept}
    med_d = _median(list(d_ref.values()))
    grad = {n: (abs(g_run[n] - g_ref[n]) / max(g_ref[n], med_g, 1e-30),
                g_run[n], g_ref[n]) for n in names}
    change = {n: (abs(d_run[n] - d_ref[n]) / max(d_ref[n], med_d, 1e-30),
                  d_run[n], d_ref[n]) for n in kept}
    return grad, change


def _direction_gaps(run: dict, ref: dict, start: Dict[str, torch.Tensor]):
    """Per leaf the rule keeps: ‖program - reference‖ / ‖reference‖ of the
    first gradient and of the change over the steps, sorted (these see a
    turned direction, which the gaps of norms do not)."""
    names = sorted(ref["first_grad"])
    g = {n: _norm(ref["first_grad"][n]) for n in names}
    med = _median(list(g.values()))
    grad, change = [], []
    for n in (n for n in names if g[n] >= 1e-3 * med):
        dev = ref["params"][n].device
        grad.append(_norm(run["first_grad"][n].double().to(dev)
                          - ref["first_grad"][n].double()) / max(g[n], 1e-30))
        s = start[n].double().to(dev)
        d_ref = ref["params"][n].double() - s
        d_run = run["params"][n].double().to(dev) - s
        change.append(_norm(d_run - d_ref) / max(_norm(d_ref), 1e-30))
    return sorted(grad), sorted(change)


def training_readings(run: dict, ref: dict, start: Dict[str, torch.Tensor]
                      ) -> Dict[str, float]:
    """run/ref: {'losses': [...], 'first_grad': {leaf: tensor}, 'params':
    {leaf: tensor after the steps}, 'running': {buffer: tensor after the
    steps}}; start: the parameters before them."""
    loss = max(abs(a - b) / max(abs(b), 1e-30)
               for a, b in zip(run["losses"], ref["losses"]))
    if len(run["losses"]) != len(ref["losses"]):
        loss = math.inf
    grad, change = _leaf_gaps(run, ref, start)
    grad_gaps = [g for g, _, _ in grad.values()]
    stats = [_norm(run["running"][n].to(ref["running"][n].device).double()
                   - ref["running"][n].double())
             / max(_norm(ref["running"][n]), 1e-30)
             for n in sorted(ref["running"])]
    return {"loss_gap": loss, "grad_gap": max(grad_gaps),
            "grad_gap_median": _median(grad_gaps),
            "change_gap": max(g for g, _, _ in change.values()),
            "stats_gap": max(stats)}


def training_details(run: dict, ref: dict, start: Dict[str, torch.Tensor],
                     top: int = 6) -> dict:
    """The leaves behind grad_gap and change_gap, worst first, as [gap,
    leaf, program's norm, reference's norm], and the best, median and worst
    leaf's gaps of direction of the first gradient and of the change (for
    calibrate.py)."""
    grad, change = _leaf_gaps(run, ref, start)

    def worst(gaps):
        return sorted(([g, n, a, b] for n, (g, a, b) in gaps.items()),
                      reverse=True)[:top]

    grad_dir, change_dir = _direction_gaps(run, ref, start)
    return {"left_out": sorted(set(grad) - set(change)),
            "grad": worst(grad), "change": worst(change),
            "grad_dir": [grad_dir[0], _median(grad_dir), grad_dir[-1]],
            "change_dir": [change_dir[0], _median(change_dir),
                           change_dir[-1]],
            "losses": [run["losses"], ref["losses"]]}


def relative_gap(run: torch.Tensor, ref: torch.Tensor) -> float:
    """‖run - ref‖ / ‖ref‖ over all elements (not finite, or shapes that
    differ: inf)."""
    if run.shape != ref.shape:
        return math.inf
    gap = _norm(run.double() - ref.double().to(run.device)) / max(
        _norm(ref), 1e-30)
    return gap if math.isfinite(gap) else math.inf


def coordinate_gap(run: torch.Tensor, ref: torch.Tensor) -> float:
    """Largest |run - ref| per last-axis coordinate over the largest
    |ref| of that coordinate; the larger over coordinates (not finite, or
    shapes that differ: inf)."""
    if run.shape != ref.shape:
        return math.inf
    run, ref = run.double().reshape(-1, run.shape[-1]), ref.double().reshape(
        -1, ref.shape[-1]).to(run.device)
    gaps = (run - ref).abs().amax(dim=0) / ref.abs().amax(dim=0).clamp_min(
        1e-30)
    gap = float(gaps.max())
    return gap if math.isfinite(gap) else math.inf


def judge(readings: Dict[str, float], limits: Dict[str, float]):
    """(correct, {name: {"value", "limit"}}): every limit must hold, and a
    reading not finite, or a limit without a reading, fails."""
    out, ok = {}, True
    for name, limit in limits.items():
        value = readings.get(name, math.inf)
        if not math.isfinite(value) or value > limit:
            ok = False
        out[name] = {"value": value, "limit": limit}
    return ok, out
