"""The benchmark's files against its own rules, on the CPU: what the
harness may import, and that `BENCHMARK.json` names only what its files
hold."""

from __future__ import annotations

import ast
import json
import os
import re
import subprocess
import sys

import pytest

from portbench.core.harness import metric_module

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
HERE = os.path.join(ROOT, "portbench")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _sources():
    for dirpath, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _top_level_imports(path: str) -> set[str]:
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(_sources()), ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax_and_references_stand_alone(path):
    names = _top_level_imports(path)
    assert not names & {"jax", "jaxlib", "flax", "tpu3drec"}, names
    if os.path.basename(os.path.dirname(path)) == "references":
        assert "tpu3drec_torch" not in names, names
    if path == os.path.abspath(__file__):
        return  # this file names them to look for them
    with open(path) as f:
        text = f.read()
    for old in ("bench.py", "BENCH_r0", "MULTICHIP_r0", "BASELINE.json", "chip_smoke"):
        if old == "chip_smoke":  # named as the origin of frozen copies, never imported
            assert "import chip_smoke" not in text
        else:
            assert old not in text, (path, old)


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_benchmark_names_its_files():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"] and b["command"] == ["python3", "portbench/run.py"]
    cells = {w["name"] for w in b["workloads"]}
    configs = {c["name"] for c in b["configs"]}
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for c in b["configs"]:
        assert NAME.match(c["name"]) and os.path.isfile(os.path.join(ROOT, c["file"]))
        assert all(NAME.match(k) for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in b["workloads"])
    for w in b["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4) and len(w["why"]) <= 200
        traffic = os.path.join(HERE, "traffic", w["traffic"] + ".json")
        with open(traffic) as f:
            entry = json.load(f)["entry"]
        assert os.path.isfile(os.path.join(HERE, "entries", entry + ".py"))
    for kind in ("end_to_end", "per_layer"):
        for m in b[kind]:
            assert NAME.match(m["name"]) and m["better"] in ("lower", "higher")
            assert set(m.get("workloads", cells)) <= cells
            assert callable(metric_module(m["name"]).read), m["name"]
            if kind == "per_layer":
                assert m["moves"] in e2e and m["layer"]
            else:
                assert 0.01 <= m["bound"] <= 0.25
    for cell in cells:  # every cell reports set-up, another end-to-end and a per-layer metric
        assert len([m for m in b["end_to_end"] if cell in m.get("workloads", cells)]) >= 2
        assert [m for m in b["per_layer"] if cell in m.get("workloads", cells)]


def test_without_a_card_the_run_prints_nothing_and_fails():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, os.path.join(HERE, "run.py"), "--workload",
                        "uav_fuse_16f", "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert p.returncode == 3 and p.stdout == ""


def test_the_run_names_a_loaded_jax_package(monkeypatch):
    import types

    from portbench.core.harness import forbidden_modules

    monkeypatch.setitem(sys.modules, "tpu3drec_torch_like", types.ModuleType("x"))
    assert forbidden_modules() == []  # a name that only begins with the package's
    monkeypatch.setitem(sys.modules, "tpu3drec.core", types.ModuleType("tpu3drec.core"))
    assert forbidden_modules() == ["tpu3drec"]
