"""The numbers that decide ``correct``, each held to its limit from the
workload file.

Frame cells: the frame the timed path produced last, against the plain
reference's frame of the same inputs, pixel by pixel (RGB):
``bad_px_share`` is the share of pixels off by more than the pixel
tolerance in some channel (a ray that grazes an edge may take the
neighbouring primitive under rounding, in either renderer);
``mean_err`` the mean of the largest channel error over the other
pixels; ``digest_gap`` the largest relative gap between the digest of a
frame of the window and the checked frame's (every frame of a window
renders the same inputs).

Gradient cells: the first ``followed_steps`` steps of the program,
against as many steps of the reference from the same inputs:
``loss_gap`` the largest relative gap of a step's loss; ``grad_gap``
the median leaf's gap between the norms of the first gradient, as the
harness's gradient descent got it; ``change_gap`` the median leaf's gap
between the norms of the parameters' change over the steps (of an even
count of leaves, the lower middle one).  A leaf's
gap is measured against the larger of the reference's norm of that leaf
and of the median leaf.  Leaves whose reference gradient is under
``leaf_floor`` times the median leaf's are left out of both; leaves
whose reference change is under ``change_floor`` float32 roundings of
the leaf (eps * |p0|) are left out of the change, which in float32
state is rounding.  The median leaf, not the worst: a silhouette pixel
where float32 and float64 disagree on hit or miss has an unbounded
d t / d radius, and moves the sphere leaves' norms by up to a fifth on
sound runs (PERF.md).
"""

from __future__ import annotations

import math
import statistics

import torch

F32_EPS = 2.0 ** -23


def frame_numbers(prog_rgb, ref_rgb, digests, tolerance: float) -> dict:
    err = (prog_rgb.double() - ref_rgb.double()).abs().amax(-1)
    bad = ~(err <= tolerance)  # a NaN pixel is bad
    good = err[~bad]
    last = digests[-1]
    return {"bad_px_share": float(bad.double().mean()),
            "mean_err": float(good.mean()) if good.numel() else math.inf,
            "digest_gap": _largest(abs(g - last) / max(abs(last), 1e-30)
                                   for g in digests)}


def _norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            tensors.items()}


class StepRecord:
    """What the first steps of a gradient system say: each step's loss,
    the first gradient's norm per leaf (as the update got it), the norm
    per leaf of the change p_n - p0, and the norm of p0."""

    def __init__(self, system):
        self.p0 = {k: v.detach().clone() for k, v in system.leaves.items()}
        self.p0_norm = _norms(self.p0)
        self.losses, self.grad, self.change = [], {}, {}

    def step(self, system):
        system.kept = {} if not self.losses else None
        self.losses.append(system.step())
        if system.kept is not None:
            self.grad = _norms(system.kept)
        system.kept = None
        self.change = _norms({k: v.detach() - self.p0[k]
                              for k, v in system.leaves.items()})

    def release(self):
        self.p0 = None


def _largest(values) -> float:
    """The largest value, inf if any is not finite (a NaN fails)."""
    values = list(values)
    return max(values) if all(math.isfinite(v) for v in values) else math.inf


def leaf_gaps(prog: dict, ref: dict, keys) -> dict:
    """Each leaf's gap between the norms, against the larger of the
    reference's norm of that leaf and of the median leaf."""
    med = statistics.median(ref.values())
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-300) for k in keys}


def _median_leaf(values) -> float:
    """The median leaf's gap (the lower of the two middle leaves of an
    even count: a leaf's gap, never a mean of two)."""
    values = list(values)
    if not values or not all(math.isfinite(v) for v in values):
        return math.inf
    return statistics.median_low(values)


def counted_leaves(ref: StepRecord, leaf_floor: float, change_floor: float):
    """(leaves whose gradient counts, leaves whose change counts)."""
    med = statistics.median(ref.grad.values())
    counted = [k for k, g in ref.grad.items() if g >= leaf_floor * med]
    # A leaf whose change is under change_floor float32 roundings of the
    # leaf moves by rounding in float32 state: its change is left out.
    moved = [k for k in counted
             if ref.change[k] >= change_floor * F32_EPS * ref.p0_norm[k]]
    return counted, moved


def grad_numbers(prog: StepRecord, ref: StepRecord, leaf_floor: float,
                 change_floor: float) -> dict:
    counted, moved = counted_leaves(ref, leaf_floor, change_floor)
    return {"loss_gap": _largest(abs(a - b) / max(abs(b), 1e-300)
                                 for a, b in zip(prog.losses, ref.losses)),
            "grad_gap": _median_leaf(leaf_gaps(prog.grad, ref.grad,
                                          counted).values()),
            "change_gap": _median_leaf(leaf_gaps(prog.change, ref.change,
                                            moved).values())}


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {value, limit}}).  A number
    that is not finite fails, and is written as 1e300: JSON has no
    infinity."""
    rows = {k: {"value": numbers[k] if math.isfinite(numbers[k]) else 1e300,
                "limit": limits[k]} for k in limits}
    return all(r["value"] <= r["limit"] for r in rows.values()), rows
