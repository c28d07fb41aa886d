"""The harness around a run: files found by name, no card no result, no
JAX, and the reference kept apart from the program."""

import ast
import json
import os
import shutil
import subprocess
import sys
import types
from pathlib import Path


from loadbench import catalog
from loadbench import run as bench

REPO = Path(__file__).resolve().parents[2]


def test_every_cell_of_the_benchmark_loads():
    b = catalog.benchmark()
    for w in b["workloads"]:
        cell = catalog.cell(w["name"])
        assert cell.config_name == w["config"] and cell.traffic_name == w["traffic"]
        assert cell.chips == w["chips"]
        catalog.load_module("entries", cell.entry)
        catalog.load_module("traffic/kinds", cell.traffic["kind"])
        family = catalog.load_module("families", cell.family)
        assert all(hasattr(family, f) for f in ("shapes", "make_weights", "engine",
                                                 "model_shape"))
        assert hasattr(catalog.load_module("reference", cell.family), "logits_at")
        assert hasattr(catalog.load_module("checks", cell.check), "read")
    for table in ("end_to_end", "per_layer"):
        for m in b[table]:
            assert hasattr(catalog.load_module("metrics", m["name"]), "read")
    for c in b["configs"]:
        assert (REPO / c["file"]).is_file()


def test_new_config_traffic_cell_and_metric_are_found_as_new_files(tmp_path, monkeypatch):
    here = tmp_path / "loadbench"
    shutil.copytree(REPO / "loadbench", here, ignore=shutil.ignore_patterns("tests"))
    bm = json.loads((REPO / "BENCHMARK.json").read_text())
    cfg = json.loads((here / "configs" / "mistral-7b.json").read_text())
    (here / "configs" / "new-model.json").write_text(json.dumps(dict(cfg, rope_theta=5e5)))
    (here / "traffic" / "kinds" / "bursty.py").write_text(
        "def schedule(mix, cell, seed, seconds, vocab):\n    return ['bursty']\n")
    (here / "traffic" / "bursts.json").write_text(json.dumps({"kind": "bursty"}))
    (here / "workloads" / "new-model.bursts.json").write_text(json.dumps(
        {"config": "new-model", "traffic": "bursts", "entry": "scheduler", "chips": 1,
         "settings": {}}))
    (here / "metrics" / "burst_ms.bursts.py").write_text(
        "def read(run):\n    return 42.0\n")
    bm["per_layer"].append({"name": "burst_ms.bursts", "unit": "ms", "better": "lower",
                            "source": "host_clock", "layer": "device",
                            "moves": "latency_p50_ms", "workloads": ["new-model.bursts"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bm))
    monkeypatch.setattr(catalog, "HERE", here)
    monkeypatch.setattr(catalog, "ROOT", tmp_path)
    cell = catalog.cell("new-model.bursts")
    assert cell.config["rope_theta"] == 5e5 and cell.traffic["kind"] == "bursty"
    kind = catalog.load_module("traffic/kinds", cell.traffic["kind"])
    assert kind.schedule(cell.traffic, cell.settings, 1, 1, 1) == ["bursty"]
    names = [m["name"] for m in catalog.metrics_for("new-model.bursts", "per_layer")]
    assert names == ["burst_ms.bursts"]
    assert catalog.load_module("metrics", names[0]).read(None) == 42.0
    assert catalog.metrics_for("mistral-7b.chat", "per_layer")  # the others stay


def _run_cli(cwd, env_extra=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH="", **(env_extra or {}))
    return subprocess.run([sys.executable, "-m", "loadbench.run", "--workload",
                           "mistral-7b.chat", "--seed", str(2 ** 31 + 3), "--seconds", "5",
                           "--trace", "0"], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=120)


def test_a_measured_run_without_a_card_fails_and_prints_no_result():
    p = _run_cli(REPO)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA device" in p.stderr


def test_a_run_from_the_benchmark_files_alone_fails(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "loadbench", tmp_path / "loadbench")
    p = _run_cli(tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    assert bench.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "layerskip_tpu_torch_like", types.ModuleType("x"))
    assert bench.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    monkeypatch.setitem(sys.modules, "layerskip_tpu.ops", types.ModuleType("y"))
    assert bench.forbidden_modules() == ["jax", "layerskip_tpu"]


def test_the_harness_and_the_port_load_no_jax():
    code = ("import sys; import loadbench.run, loadbench.check, loadbench.entries.scheduler, "
            "loadbench.tools.calibrate, "
            "layerskip_tpu_torch.serving, layerskip_tpu_torch.generation.engine; "
            "print(loadbench.run.forbidden_modules())")
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"


def test_the_reference_imports_nothing_of_the_program():
    banned = {"jax", "jaxlib", "flax", "layerskip_tpu", "layerskip_tpu_torch"}
    for path in (REPO / "loadbench" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            assert not {n.split(".")[0] for n in names} & banned, (path, names)
    code = ("import sys, loadbench.reference.mistral, loadbench.check, "
            "loadbench.checks.gap, loadbench.families.mistral; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] == "
            "'layerskip_tpu_torch'))")
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode == 0 and p.stdout.strip() == "[]", p.stderr
