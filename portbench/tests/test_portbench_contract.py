"""BENCHMARK.json against the benchmark's contract: its keys, names and
units in the allowed characters, every file it names present, every cell
reporting set-up, another end-to-end metric and a per-layer metric."""
import json
import re

import pytest

from portbench.lib import catalog

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
BENCH = catalog.benchmark()
METRIC_KEYS = {"name", "unit", "better", "bound", "source", "workloads"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves",
              "workloads"}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) < 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in BENCH["paths"])


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"]
                         + BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda e: e["name"])
def test_names_units_and_text(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200
            assert "\n" not in entry[key] and "\t" not in entry[key]
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    for key in entry.get("reduced", []):
        assert NAME.match(key)


def test_metric_entries():
    for m in BENCH["end_to_end"]:
        assert set(m) <= METRIC_KEYS
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= LAYER_KEYS
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))


@pytest.mark.parametrize("wl", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_cell_is_whole(wl):
    assert wl["chips"] in (1, 4)
    assert len(wl["why"]) <= 200
    e2e = catalog.metrics_of(BENCH, wl["name"], traced=False)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    layers = catalog.metrics_of(BENCH, wl["name"], traced=True)
    assert layers
    for m in layers:
        assert m["moves"] in names
    for m in e2e + layers:
        assert hasattr(catalog.reader(m["name"]), "read")
    catalog.config(wl["config"])
    catalog.traffic(wl["traffic"])
    catalog.limits(wl["name"])


def test_config_files_are_distinct_and_under_paths():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert any(c["name"] == w["config"] for w in BENCH["workloads"])


def test_train_config_sizes_match_its_setting():
    cfg = catalog.config("liftreg160_ref_f32")
    setting = cfg["setting"]
    assert setting["dataset"]["img_after_resize"] == cfg["img_sz"]
    assert setting["train"]["model"]["latent_dim"] == cfg["latent_dim"]
    assert setting["train"]["model"]["drr_feature_num"] == cfg["n_proj"]
    assert setting["train"]["dataloader"]["batch_size"] == \
        catalog.traffic("train_b30")["batch"]
