"""The numbers that decide ``correct``, each worked out from the program's
readings and the plain reference's.

Training (the first three steps of the Trainer, against the reference's):

- ``loss``: the largest relative gap of a step's total loss,
  max_t |l_prog - l_ref| / |l_ref|;
- ``grad``: by the worst leaf, the gap between the norms of the first
  step's gradient (the program's worked out from its AdamW state after
  one step: exp_avg / (1 - beta1)), | |g_prog| - |g_ref| |, over the
  larger of the reference's norm of that leaf and of the median leaf;
- ``change``: the same of the norm of each parameter's change over the
  three steps (the state that step 4 starts from), over the leaves whose
  reference gradient is at least a thousandth of the median leaf's (a
  leaf with a gradient that is nought to rounding moves under Adam by
  round-off alone; such leaves are left out by this rule, not by name).

Serving: ``raster``, the largest absolute difference in metres between a
written raster and the reference's, over a sample of the window's scenes
drawn from the seed; a raster that was never written counts as failed.
"""

from __future__ import annotations

import statistics


def loss_gap(prog: list, ref: list) -> float:
    return max(abs(p - r) / abs(r) for p, r in zip(prog, ref))


def norm_gap(prog: dict, ref: dict, keep=None) -> tuple:
    """(largest gap, its leaf) of per-leaf norms, against the larger of the
    leaf's and the median leaf's reference norm; ``keep`` the leaves
    counted (all by default)."""
    names = [n for n in ref if keep is None or n in keep]
    med = statistics.median(ref[n] for n in names)
    worst, leaf = 0.0, None
    for n in names:
        gap = abs(prog[n] - ref[n]) / max(ref[n], med)
        if gap > worst or leaf is None:
            worst, leaf = gap, n
    return worst, leaf


def moved_leaves(ref_grad: dict) -> set:
    """Leaves whose reference gradient norm is at least a thousandth of the
    median leaf's."""
    med = statistics.median(ref_grad.values())
    return {n for n, g in ref_grad.items() if g >= 1e-3 * med}


def train_numbers(prog: dict, ref: dict) -> dict:
    """{name: (value, worst leaf or None)} of the three training numbers."""
    grad, gleaf = norm_gap(prog["grad"], ref["grad"])
    change, cleaf = norm_gap(prog["change"], ref["change"],
                             moved_leaves(ref["grad"]))
    return {"loss": (loss_gap(prog["losses"], ref["losses"]), None),
            "grad": (grad, gleaf), "change": (change, cleaf)}
