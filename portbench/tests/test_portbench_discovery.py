"""A cell is added by adding files alone: in a copy of the benchmark, a
new configuration, traffic mix, per-layer metric reader, roofline count
and limits file, with the new cell and metric entered in BENCHMARK.json,
are found by name and run, and no file of the copy is edited."""
import hashlib
import json
import os
import shutil
import subprocess
import sys

from portbench.lib import catalog

ROOT = str(catalog.CHECKOUT)


def _digests(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            if "__pycache__" in dirpath:
                continue
            p = os.path.join(dirpath, f)
            out[os.path.relpath(p, root)] = hashlib.sha256(
                open(p, "rb").read()).hexdigest()
    return out


def test_new_cell_from_files_alone(tmp_path):
    shutil.copytree(catalog.BENCH_DIR, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(tmp_path / "portbench")
    pb = tmp_path / "portbench"
    cfg = catalog.config("liftreg160_serve_bf16")
    cfg.update(img_sz=[32, 32, 32], resolution=[48, 48])
    (pb / "configs" / "tiny_serve.json").write_text(json.dumps(cfg))
    traffic = catalog.traffic("sync_b4")
    traffic.update(batch=2, pool=2, warm_calls=1, check_span=3,
                   check_calls=1, trace_seconds=0.05)
    (pb / "traffic" / "tiny_sync.json").write_text(json.dumps(traffic))
    (pb / "metrics" / "calls.tiny.py").write_text(
        "def read(run):\n    return float(run.window['calls'])\n")
    (pb / "rooflines" / "tiny_op.py").write_text(
        'COUNTER = "warp_trilinear"\nPATTERNS = ("no_such_kernel",)\n\n\n'
        "def cost(s):\n    return 1, 1, 'float32'\n")
    (pb / "limits" / "tiny_cell.json").write_text(
        json.dumps(catalog.limits("serve_b4_sync")))
    bench = catalog.benchmark()
    bench["workloads"].append({"name": "tiny_cell", "config": "tiny_serve",
                               "traffic": "tiny_sync", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({"name": "calls.tiny", "unit": "calls",
                               "better": "higher", "source": "host_clock",
                               "layer": "entry", "moves": "reg_p95_ms",
                               "workloads": ["tiny_cell"]})
    for m in bench["end_to_end"]:
        if m["name"] == "reg_p95_ms":
            m["workloads"].append("tiny_cell")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {str(tmp_path)!r})\n"
        f"sys.path.append({ROOT!r})\n"
        "from portbench.lib import catalog, cell\n"
        "assert 'tiny_op' in catalog.rooflines()\n"
        "for t in (0, 1):\n"
        "    r = cell.run(['--workload', 'tiny_cell', '--seed', '7',\n"
        "                  '--seconds', '0.1', '--trace', str(t)],\n"
        "                 device='cpu')\n"
        "    print(json.dumps(r['metrics']), r['correct'])\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    untraced, traced = out.stdout.strip().splitlines()[-2:]
    assert "reg_p95_ms" in untraced and untraced.endswith("True")
    assert "calls.tiny" in traced and traced.endswith("True")
    after = _digests(tmp_path / "portbench")
    assert all(after[k] == v for k, v in before.items())
