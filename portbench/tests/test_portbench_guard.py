"""The import guard: no module whose top-level name is jax, jaxlib, flax
or liftreg_tpu is loaded by a run, a run that finds one prints no result
and exits 3, and the reference imports nothing of the port."""
import ast
import contextlib
import io
import pathlib
import sys
import types

import tiny
from portbench.lib import catalog, cell

REFERENCE = pathlib.Path(catalog.BENCH_DIR) / "reference"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_reference_imports_nothing_of_the_port_or_jax():
    for path in REFERENCE.glob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & {"liftreg_tpu_torch", *cell.FORBIDDEN}, path


def test_forbidden_compares_whole_top_level_names():
    assert cell.forbidden_modules() == []
    sys.modules["liftreg_tpu_torchx"] = types.ModuleType("x")
    try:
        assert cell.forbidden_modules() == []
    finally:
        del sys.modules["liftreg_tpu_torchx"]


def test_run_loads_no_forbidden_module():
    res = cell.run(tiny.argv("serve_b4_sync"), device="cpu",
                   overrides=tiny.overrides("serve_b4_sync"))
    assert res["correct"]
    assert not {n.split(".")[0] for n in sys.modules} & set(cell.FORBIDDEN)


def test_a_forbidden_module_refuses_the_run():
    sys.modules["jax"] = types.ModuleType("jax")
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            rc = cell.main(tiny.argv("serve_b4_sync"), device="cpu",
                           overrides=tiny.overrides("serve_b4_sync"))
    finally:
        del sys.modules["jax"]
    assert rc == 3 and out.getvalue() == ""


def test_no_card_refuses_the_run(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cell.main(tiny.argv("serve_b4_stream"))
    assert rc == 3 and out.getvalue() == ""
