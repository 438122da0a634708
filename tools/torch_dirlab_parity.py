"""DirLab per-case TRE parity harness of the PyTorch port.

One command that diffs the port's DirLab COPDgene results against pinned
expectations (``tools/dirlab_expectations.json``):

* ``--identity``: the reference's own oracle (``test_evaluation_script``
  of its ``tools/evaluate_dir_lab.py``): evaluating the identity map must
  reproduce each case's published initial landmark distance (Castillo et
  al. PMB 2013; mean 23.36 mm). Validates the whole landmark ->
  coordinate-transform -> phi-sampling -> mm chain against ground truth
  that exists independently of any training run.
* ``--exp EXP``: diff a finished experiment's per-case TRE
  (``<EXP>/tests/{case}_phi.npy`` via ``eval_copd_highres``) against the
  paper's published numbers (``published.per_case_tre_mm``; null in the
  shipped file: fill them from arXiv 2203.05565 before use) or any
  ``--expected`` JSON of the same shape.
* ``--raw RAW``: run the full raw-bytes -> CSV chain first
  (``tools/torch_dirlab_e2e.py``) and then diff: pointed at a raw DirLab
  folder, it runs preprocessing -> DRR -> train -> eval and diffs per-case
  TRE against the table.

Exit status: 0 when every compared case is within tolerance, 1 otherwise,
with a per-case expected/actual/diff table either way. Cases without an
expectation (or with null) are reported but not failed. The identity
check is host arithmetic; ``--exp`` and ``--raw`` run on the CUDA card
unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from liftreg_tpu_torch.device import resolve_device  # noqa: E402
from liftreg_tpu_torch.utils import tre  # noqa: E402

DEFAULT_EXPECTATIONS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                    "dirlab_expectations.json")


def load_expectations(path):
    with open(path) as f:
        return json.load(f)


def diff_table(actual, expected, tol, label):
    """Compare per-case scalars; returns (n_fail, lines). Cases missing an
    expectation (or expected null) are listed as SKIP, not failed."""
    lines = [f"-- {label} (tol {tol} mm) --",
             f"{'case':<10} {'expected':>9} {'actual':>9} {'diff':>8}  verdict"]
    n_fail = 0
    for case in sorted(actual, key=_case_key):
        act = actual[case]
        exp = expected.get(case)
        if exp is None:
            lines.append(f"{case:<10} {'--':>9} {act:9.3f} {'--':>8}  SKIP "
                         f"(no expectation)")
            continue
        diff = act - exp
        ok = abs(diff) <= tol
        n_fail += 0 if ok else 1
        lines.append(f"{case:<10} {exp:9.3f} {act:9.3f} {diff:+8.3f}  "
                     f"{'ok' if ok else 'FAIL'}")
    if "mean" in expected and expected["mean"] is not None and actual:
        mean = float(np.mean(list(actual.values())))
        diff = mean - expected["mean"]
        ok = abs(diff) <= tol
        n_fail += 0 if ok else 1
        lines.append(f"{'mean':<10} {expected['mean']:9.3f} {mean:9.3f} "
                     f"{diff:+8.3f}  {'ok' if ok else 'FAIL'}")
    return n_fail, lines


def _case_key(case):
    digits = "".join(c for c in case if c.isdigit())
    return (case.rstrip("0123456789"), int(digits) if digits else 0)


def _case_geometry(data_path, case, dim, spacing_table):
    """(origin, phi_spacing, landmark spacing) exactly as
    ``eval_copd_highres`` resolves them."""
    prop_file = os.path.join(data_path, "preprocessed", f"{case}_prop.npy")
    if os.path.exists(prop_file):
        prop = np.load(prop_file, allow_pickle=True).item()
        origin = np.flip(np.asarray(prop["origin"])).copy()
        phi_spacing = np.flip(np.asarray(prop["spacing"])).copy()
    else:
        origin = np.zeros(3)
        phi_spacing = np.full(3, 2.2)
    spacing = spacing_table.get(case, phi_spacing)
    return origin, phi_spacing, np.asarray(spacing, np.float64)


def identity_tre(data_path, cases, dim, spacing_table, expect_count=None):
    """Per-case TRE of the identity map = initial landmark distance."""
    lm = os.path.join(data_path, "landmarks")
    out = {}
    phi01 = tre.create_identity(dim)[None]
    for case in cases:
        src = os.path.join(lm, f"{case}_300_iBH_xyz_r1.txt")
        tgt = os.path.join(lm, f"{case}_300_eBH_xyz_r1.txt")
        if not (os.path.exists(src) and os.path.exists(tgt)):
            continue
        origin, phi_spacing, spacing = _case_geometry(
            data_path, case, dim, spacing_table)
        # phi (not phi-inverse) convention: the landmark files swap roles,
        # as in eval_copd_highres
        src_pts = tre.read_points(tgt, expect_count=expect_count)
        tgt_pts = tre.read_points(src, expect_count=expect_count)
        res, _, _ = tre.eval_with_data(src_pts, tgt_pts, phi01,
                                       np.asarray(dim), spacing, origin,
                                       phi_spacing)
        out[case] = float(res)
    return out


def experiment_tre(data_path, exp_path, dim, spacing_table, device=None):
    results = tre.eval_copd_highres(data_path, exp_path,
                                    spacing_table=spacing_table, dim=dim,
                                    device=device)
    return {r["id"].split("_")[0]: float(r["dist"]) for r in results}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--data", help="task root (preprocessed/ + landmarks/)")
    p.add_argument("--exp", help="experiment dir holding tests/{case}_phi.npy")
    p.add_argument("--raw", help="raw DirLab folder: run the full "
                                 "torch_dirlab_e2e chain first")
    p.add_argument("--landmarks", default="", help="landmark txt folder "
                                                   "(with --raw)")
    p.add_argument("--out", default="", help="output root (with --raw)")
    p.add_argument("--identity", action="store_true",
                   help="check the identity-map oracle instead of an "
                        "experiment")
    p.add_argument("--expected", default=DEFAULT_EXPECTATIONS,
                   help="expectations JSON "
                        "(default tools/dirlab_expectations.json)")
    p.add_argument("--size", type=int, default=160)
    p.add_argument("--tol", type=float, default=None,
                   help="override tolerance in mm")
    p.add_argument("--epochs", type=int, default=300, help="(with --raw)")
    p.add_argument("--pca_path", default="", help="(with --raw)")
    p.add_argument("--enforce_landmark_count", action="store_true",
                   help="require exactly landmarks_per_case points per file "
                        "(300 for DirLab)")
    p.add_argument("--device", default=None,
                   help="'cpu' for the kernels' plain versions; default "
                        "the CUDA card")
    args = p.parse_args(argv)
    # the experiment's evaluation and the chain run on a device; the
    # identity check is host arithmetic
    device = resolve_device(args.device) if args.exp or args.raw else None

    exp_cfg = load_expectations(args.expected)
    dim = (args.size,) * 3
    spacing_table = tre.COPD_SPACING
    expect_count = (exp_cfg.get("landmarks_per_case")
                    if args.enforce_landmark_count else None)

    if args.raw:
        from tools.torch_dirlab_e2e import main as e2e_main
        if not args.out:
            p.error("--raw requires --out")
        e2e_argv = ["--raw_path", args.raw, "--out", args.out,
                    "--epochs", str(args.epochs), "--size", str(args.size)]
        if args.landmarks:
            e2e_argv += ["--landmarks", args.landmarks]
        if args.pca_path:
            e2e_argv += ["--pca_path", args.pca_path]
        if args.device:
            e2e_argv += ["--device", args.device]
        e2e_main(e2e_argv)
        args.data = os.path.join(os.path.abspath(args.out), "dataset")
        args.exp = os.path.join(os.path.abspath(args.out), "exp")

    if not args.data:
        p.error("--data (or --raw) is required")

    n_fail = 0
    reports = []
    if args.identity or not args.exp:
        expected = dict(exp_cfg.get("initial_tre_mm", {}))
        cases = [c for c in expected if c != "mean"]
        if not cases:  # fall back to whatever landmarks exist on disk
            lm = os.path.join(args.data, "landmarks")
            cases = sorted({f.split("_300_")[0] for f in os.listdir(lm)
                            if f.endswith(".txt")})
        actual = identity_tre(args.data, cases, dim, spacing_table,
                              expect_count=expect_count)
        if not actual:
            print("no landmark files found — nothing to check", file=sys.stderr)
            return 1
        tol = args.tol if args.tol is not None else \
            exp_cfg.get("initial_tol_mm", 0.75)
        f, lines = diff_table(actual, expected, tol,
                              "identity-map TRE vs published initial "
                              "landmark distance")
        n_fail += f
        reports += lines

    if args.exp:
        pub = exp_cfg.get("published", {})
        expected = dict(pub.get("per_case_tre_mm", {}))
        expected["mean"] = pub.get("mean_tre_mm")
        actual = experiment_tre(args.data, args.exp, dim, spacing_table,
                                device=device)
        if not actual:
            print(f"no saved phis under {args.exp}/tests — run eval first",
                  file=sys.stderr)
            return 1
        tol = args.tol if args.tol is not None else pub.get("tol_mm", 0.5)
        f, lines = diff_table(actual, expected, tol,
                              "experiment TRE vs published method TRE")
        n_fail += f
        reports += lines

    print("\n".join(reports))
    print(f"\n{'PARITY OK' if n_fail == 0 else f'PARITY FAIL ({n_fail} checks out of tolerance)'}")
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
