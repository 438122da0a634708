"""Readings that the limits of ``portbench/limits/<workload>.json`` are set
from, for one cell over many seeds in one process:

    python3 portbench/control.py --workload <name> --seeds 1 2 3 ... \
        [--control-seeds 3] [--judge]

For each seed it makes the cell's inputs and weights, runs the program at
the cell's own load (serving: a closed loop of the traffic's
``check_span`` calls, ``in_flight`` deep; training: the three checked
steps) and prints one JSON line with the program's numbers against the
plain reference (``program``), and, for the first ``--control-seeds``
seeds, the control's (``control``): the reference computed one step below
the configuration's precision (float8 for bf16, TF32 for f32 with TF32
off) put in the program's place; for training also the fault of half the
batch left out (``half_batch``). The program's readings over a dozen
seeds give each limit's lower reading; the control's and the faults'
smallest its upper. ``--judge`` then holds every row against the cell's
limits by the decision a run makes (:func:`check.verdict`): the program
has to come out correct on each seed, and the control and each fault not
correct; the exit code is 1 where one does not.
"""
import argparse
import gc
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
os.environ["LIFTREG_NO_TB"] = "1"

import torch  # noqa: E402

from portbench.lib import (catalog, cell, check, inputs, loops,  # noqa: E402
                           program)
from portbench.reference.liftreg import LiftReg, leaves  # noqa: E402


def _train_prog(reference, w, pca, batches, setting):
    """The numbers' inputs (losses, first gradient norms, change norms) of
    ``reference`` run in the program's place."""
    opt, loss = setting["train"]["optim"], setting["train"]["loss"]
    losses, grads, params = reference.train(
        w, pca, batches, lr=float(opt["lr"]),
        reg_factor=float(loss["initial_reg_factor"]),
        betas=tuple(opt["adam"]["beta"]))
    return {"losses": losses, "grads": [float(g.norm()) for g in grads],
            "change": [float((p - p0).norm())
                       for p, p0 in zip(params, leaves(w))]}


def readings(workload, seeds, control_seeds, device=None, overrides=None):
    bench = catalog.benchmark()
    wl = catalog.workload(bench, workload)
    cfg = catalog.config(wl["config"])
    traffic = catalog.traffic(wl["traffic"])
    for key, part in (overrides or {}).items():
        {"config": cfg, "traffic": traffic}[key].update(part)
    dev = torch.device(device or "cuda")
    batch = int(traffic["batch"])
    maker = LiftReg(cfg, dev)
    low, tf32 = check.precision_of(cfg)
    c_low, c_tf32 = check.precision_of(cfg, control=True)
    reference = LiftReg(cfg, dev, low, tf32, geometry=maker.geometry)
    control = LiftReg(cfg, dev, c_low, c_tf32, geometry=maker.geometry)
    for k, seed in enumerate(seeds):
        w = inputs.weights(seed, cfg, dev)
        pca = inputs.basis(seed, cfg, dev)
        row = {"seed": seed}
        if traffic["kind"] == "serve":
            pool = inputs.serve_pool(seed, cfg, batch, int(traffic["pool"]),
                                     maker, dev)
            server = program.Server(cfg, traffic, w, pca, dev)
            keep = cell.check_indices(seed, int(traffic["check_span"]),
                                      int(traffic["check_calls"]))
            win = loops.closed_loop(server, pool, dev,
                                    int(traffic.get("in_flight", 1)), 0.0,
                                    int(traffic["check_span"]), keep)
            del server
            row["program"] = check.serve_numbers(traffic, win["kept"], pool,
                                                 w, pca, reference)
            if k < control_seeds:
                refine = traffic.get("refine_steps") and (
                    int(traffic["refine_steps"]),
                    float(traffic.get("refine_lr", 0.05)),
                    float(traffic.get("refine_reg_factor", 1e-3)))
                kept = {}
                for i in keep:
                    item = pool[i % len(pool)]
                    out = control.serve(w, pca, item["source_hu"],
                                        item["source_seg"],
                                        item["target_proj"],
                                        refine=refine or None)
                    # the outputs the program's call gives
                    totals = out.pop("totals", None)
                    if totals is not None:
                        out["history"] = check.history_of(totals)
                    kept[i] = out
                row["control"] = check.serve_numbers(traffic, kept, pool, w,
                                                     pca, reference)
        else:
            pool = inputs.train_pool(seed, cfg, batch, int(traffic["pool"]),
                                     maker, dev)
            steps = [pool[j % len(pool)]
                     for j in range(int(traffic["warm_calls"]))]
            with tempfile.TemporaryDirectory(prefix="portbench_") as tmp:
                trainer = program.Trainer(cfg, w, pca, dev, tmp)
                prog = trainer.checked_steps(steps, w)
                del trainer
            gc.collect()
            setting = cfg["setting"]
            row["program"] = check.train_numbers(prog, reference, w, pca,
                                                 steps, setting)
            if k < control_seeds:
                ctl = _train_prog(control, w, pca, steps, setting)
                row["control"] = check.train_numbers(ctl, reference, w, pca,
                                                     steps, setting)
                # the fault of half the batch left out, the mean taken over
                # the rest, planted in the reference put in the program's
                # place
                halves = [{key: torch.cat([v[:batch // 2]] * 2)
                           for key, v in b.items()} for b in steps]
                half = _train_prog(reference, w, pca, halves, setting)
                row["half_batch"] = check.train_numbers(half, reference, w,
                                                        pca, steps, setting)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        yield row


#: what each reading has to come out as under the cell's limits
WANT_CORRECT = {"program": True, "control": False, "half_batch": False}


def judge(workload, rows):
    """The verdicts of ``rows`` (:func:`readings`') under the cell's
    limits: (seed, reading, correct, whether that is as it should be)."""
    limits = catalog.limits(workload)
    out = []
    for row in rows:
        for name, want in WANT_CORRECT.items():
            if name in row:
                ok = check.verdict(row[name], limits)[1]
                out.append((row["seed"], name, ok, ok == want))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--judge", action="store_true")
    args = ap.parse_args()
    rows = []
    for row in readings(args.workload, args.seeds, args.control_seeds):
        print(json.dumps(row), flush=True)
        rows.append(row)
    if not args.judge:
        return 0
    verdicts = judge(args.workload, rows)
    for seed, name, ok, as_due in verdicts:
        print(f"judge {args.workload} seed {seed} {name} correct {ok} "
              f"{'as due' if as_due else 'WRONG'}", file=sys.stderr)
    return 0 if all(v[3] for v in verdicts) else 1


if __name__ == "__main__":
    raise SystemExit(main())
