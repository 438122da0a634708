"""A cell cut to a size that a CPU test holds: 32^3 volumes on a 48^2
detector, batches of 2, a pool of 2, 3 refinement steps; the widths,
views and latent as configured."""
import copy

from portbench.lib import catalog


def overrides(workload):
    bench = catalog.benchmark()
    wl = catalog.workload(bench, workload)
    cfg = catalog.config(wl["config"])
    traffic = catalog.traffic(wl["traffic"])
    ov = {"config": {"img_sz": [32, 32, 32], "resolution": [48, 48]},
          "traffic": {"batch": 2, "pool": 2, "check_span": 3,
                      "check_calls": 2, "trace_seconds": 0.05}}
    if traffic["kind"] == "serve":
        ov["traffic"]["warm_calls"] = 1
    if "setting" in cfg:
        setting = copy.deepcopy(cfg["setting"])
        setting["dataset"]["img_after_resize"] = [32, 32, 32]
        setting["train"]["dataloader"]["batch_size"] = 2
        ov["config"]["setting"] = setting
    if traffic.get("refine_steps"):
        ov["traffic"]["refine_steps"] = 3
        ov["traffic"]["unrefined_calls"] = 2
    return ov


def argv(workload, seed=2147483701, trace=0):
    return ["--workload", workload, "--seed", str(seed), "--seconds", "0.2",
            "--trace", str(trace)]
