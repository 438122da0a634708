"""The comparison that decides ``correct``: what the timed path produced,
held against the plain reference (:mod:`portbench.reference.liftreg`) on
the same inputs and weights.

Serving (each sampled call of the window, the worst of them):
``phi_err``, the largest gap of phi (normalized coordinates: 2 over the
axis' voxels less one is a voxel); ``warped_err``, the largest gap of the
warped normalized CT. With refinement the refined coefficients are not
compared one by one: Adam's first step moves each by +-lr by the sign of
its gradient, and where that gradient is at the rounding level (in about
one call in ten, a coefficient's is a thousandth of the median one's) the
sign, and the case's whole trajectory after it, is rounding's. So the
refinement is held by what it achieves and by the two ends that the
trajectory joins: ``start_err``, the relative gap of the objective of the
unrefined coefficients (the program's first history entry) from the
reference's; ``gain_gap``, the largest over the cases of the share of the
reference's gain (its objective at the unrefined coefficients less that
at its best iterate) that the program's refined coefficients miss, by the
reference's objective; ``history_gap``, the widest gap of the program's
objective history (the batch mean at each evaluated iterate, the last
entry that of the returned iterates) from the reference's, over the
reference's gain: a coefficient that rounding sends the other way has a
gradient near nought, and moves the objective little, while a wrong
update (its rate, its moments, its bias correction) moves it from the
first step on; and phi and the warped CT against the reference's at the
program's refined coefficients.

Training (the first three steps of the object the window drives):
``loss_gap``, the largest relative gap of a step's loss; ``grad_gap``, the
worst leaf's gap between the norms of the first gradient (as the
optimizer's first moment holds it after one step) over the larger of that
leaf's reference norm and the median leaf's; ``change_gap``, the same of
the parameters' change over the three steps, over the leaves whose
reference gradient is at least a thousandth of the median leaf's.
"""
from __future__ import annotations

import math

import torch

from portbench.reference import liftreg as ref

#: a leaf whose reference gradient is below this share of the median
#: leaf's moves under Adam by round-off alone and is left out of the change
STILL_LEAF = 1e-3


def precision_of(cfg, control=False):
    """(low, tf32) of the reference for ``cfg``, or of its control: one
    step below the stated precision (float8 for bfloat16, TF32 for f32
    with TF32 off)."""
    low = cfg["compute_dtype"] or "float32"
    if not control:
        return low, False
    if low == "float32":
        return "float32", True
    return "float8_e4m3fn", False


def serve_numbers(traffic, kept, pool, w, pca, reference):
    """The serving numbers of the calls in ``kept`` ({index: the program's
    output dict}); ``reference`` a :class:`~liftreg.LiftReg` to hold them
    against. A call that gave no output, or not a row for each case,
    reads infinite gaps."""
    refine = None
    if traffic.get("refine_steps"):
        refine = (int(traffic["refine_steps"]),
                  float(traffic.get("refine_lr", 0.05)),
                  float(traffic.get("refine_reg_factor", 1e-3)))
    worst = {"phi_err": 0.0, "warped_err": 0.0}
    if refine:
        worst.update(start_err=0.0, gain_gap=-math.inf, history_gap=0.0)
    for i, out in sorted(kept.items()):
        item = pool[i % len(pool)]
        rows = item["source_hu"].shape[0]
        if out is None or any(out[k].shape[0] != rows
                              for k in ("phi", "warped", "coefs")
                              if k in out):
            return {k: math.inf for k in worst}
        r = reference.serve(w, pca, item["source_hu"], item["source_seg"],
                            item["target_proj"], refine=refine)
        if refine:
            coefs = out["coefs"].float()
            j0, jbest = r["totals"][0], r["totals"].min(dim=0).values
            j = reference.objective(pca, item["source_hu"],
                                    item["target_proj"], coefs, refine[2])
            gain = ((j - jbest) / (j0 - jbest)).max()
            start = (float(out["start"]) - float(r["start"])) \
                / float(r["start"])
            history = history_gap(out["history"], r["totals"])
            r = reference.outputs(pca, item["source_hu"], item["source_seg"],
                                  coefs)
        nums = {"phi_err": float((out["phi"].float() - r["phi"]).abs().max()),
                "warped_err": float((out["warped"].float()
                                     - r["warped"]).abs().max())}
        if refine:
            nums["start_err"] = abs(start)
            nums["gain_gap"] = float(gain)
            nums["history_gap"] = history
        for k, v in nums.items():
            worst[k] = v if not math.isfinite(v) else max(worst[k], v)
        del r
    return worst


def history_of(totals):
    """The program's ``total_history`` of a reference's ``totals`` (steps
    + 1, B): the batch mean at each iterate but the last, then that of
    each case's best."""
    return torch.cat([totals[:-1].mean(dim=1),
                      totals.min(dim=0).values.mean()[None]])


def history_gap(history, totals):
    """The widest gap of ``history`` (the program's) from the reference's
    ``totals``, over the reference's gain (its first entry less its
    last); infinite where the lengths differ."""
    ref_history = history_of(totals)
    history = history.float().to(ref_history.device)
    if history.shape != ref_history.shape:
        return math.inf
    gain = float(ref_history[0] - ref_history[-1])
    return float((history - ref_history).abs().max()) / gain


def verdict(numbers, limits):
    """Each number with its limit, and whether all are within them (a
    number that is not finite is not)."""
    checks = {k: {"value": v, "limit": float(limits[k])}
              for k, v in numbers.items()}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return checks, ok


def _gap(prog, refs, mask=None):
    """The worst leaf's gap of norms over max(its reference norm, the
    median leaf's), over the leaves in ``mask``."""
    med = float(torch.tensor(refs).median())
    gaps = [abs(p - r) / max(r, med) for k, (p, r) in enumerate(zip(prog,
                                                                    refs))
            if mask is None or mask[k]]
    return max(gaps)


def train_numbers(prog, reference, w, pca, batches, setting):
    """``prog``: the program's ``losses`` (3), ``grads`` (the first
    gradient by leaf) and ``change`` (the parameters' change by leaf after
    the three steps). The reference runs the same three steps from the
    same weights."""
    opt = setting["train"]["optim"]
    loss_opt = setting["train"]["loss"]
    reg_factor = float(loss_opt["initial_reg_factor"])
    losses, grads, params = reference.train(
        w, pca, batches, lr=float(opt["lr"]), reg_factor=reg_factor,
        betas=tuple(opt["adam"]["beta"]))
    g_ref = [float(g.norm()) for g in grads]
    d_ref = [float((p - p0).norm())
             for p, p0 in zip(params, ref.leaves(w))]
    med_g = float(torch.tensor(g_ref).median())
    moving = [g >= STILL_LEAF * med_g for g in g_ref]
    loss_gap = max(abs(lp - lr) / abs(lr) for lp, lr in zip(prog["losses"],
                                                            losses))
    return {"loss_gap": loss_gap,
            "grad_gap": _gap(prog["grads"], g_ref),
            "change_gap": _gap(prog["change"], d_ref, moving)}
