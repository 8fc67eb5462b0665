"""Every cell resolves from its names alone, and BENCHMARK.json keeps to its format."""
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

import harness
from conftest import BENCH_DIR

BENCHMARK = harness.load_json(harness.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCHMARK["workloads"]])
def test_every_cell_resolves(cell):
    found = harness.resolve(cell)
    assert found.config["name"] == found.entry["config"]
    assert callable(found.loop.run)
    assert found.limits and all(v >= 0 for v in found.limits.values())
    assert {m["name"] for m in found.end_to_end} >= {"setup_s"}
    assert len(found.end_to_end) >= 2 and found.per_layer
    for name, reader in found.readers.items():
        assert callable(reader.read), name


def test_benchmark_format():
    b = BENCHMARK
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    cells = {w["name"] for w in b["workloads"]}
    configs = {c["name"] for c in b["configs"]}
    metric_names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert os.path.isfile(harness.ROOT / c["file"])
        assert any(w["config"] == c["name"] for w in b["workloads"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4) and len(w["why"]) <= 200
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and os.path.isfile(BENCH_DIR / "metrics" / f"{m['name']}.py")
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                   "higher")
        assert set(m.get("workloads", cells)) <= cells
    for name in cells | configs:
        assert NAME.match(name)
    for w in b["workloads"]:  # every cell reports set-up, another end-to-end metric, a layer
        mine = [m for m in b["end_to_end"] if w["name"] in m.get("workloads", cells)]
        assert "setup_s" in {m["name"] for m in mine} and len(mine) >= 2
        assert any(w["name"] in m.get("workloads", cells) for m in b["per_layer"])
    assert len(json.dumps(b)) < 64 * 1024


def test_a_new_cell_is_found_from_files_alone(tmp_path):
    """A cell added as data (an entry, a traffic file, a limits file) and a
    metric added as a reader file resolve with no code edited."""
    bench = tmp_path / "benchmark_torch"
    shutil.copytree(BENCH_DIR, bench, ignore=shutil.ignore_patterns("corpus", ".cache",
                                                                     "__pycache__"))
    traffic = harness.load_json(bench / "traffic" / "train.ctx32.json")
    traffic["pool"]["context"] = 16
    (bench / "traffic" / "train.ctx16.json").write_text(json.dumps(traffic))
    (bench / "limits" / "clip_b32.train.ctx16.json").write_text(
        json.dumps({"loss_gap": 0.1, "grad_gap": 0.1, "change_gap": 0.1}))
    (bench / "metrics" / "steps.train.py").write_text("def read(run):\n    return 1.0\n")
    b = json.loads(json.dumps(BENCHMARK))
    b["workloads"].append({"name": "clip_b32.train.ctx16", "config": "clip_b32",
                           "traffic": "train.ctx16", "chips": 1, "why": "a test"})
    b["per_layer"].append({"name": "steps.train", "unit": "steps", "better": "higher",
                           "source": "host_clock", "layer": "Solver loop",
                           "moves": "train_pairs_per_s", "workloads": ["clip_b32.train.ctx16"]})
    found = harness.resolve("clip_b32.train.ctx16", b, bench_dir=bench)
    assert found.traffic["pool"]["context"] == 16
    assert found.readers["steps.train"].read(None) == 1.0
    assert found.loop.__file__ == str(bench / "loops" / "train.py")
    with pytest.raises(KeyError):
        harness.resolve("clip_b32.train.ctx8", b, bench_dir=bench)


def test_no_card_no_result(tmp_path):
    """Without a CUDA card the run fails and prints no result line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, str(BENCH_DIR / "run.py"), "--workload",
                           "fdt_b32.train.ctx32", "--seed", "3", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, env=env, timeout=300,
                          cwd=harness.ROOT)
    assert proc.returncode != 0
    assert "correct" not in proc.stdout


def test_harness_imports_no_jax():
    """Nothing the harness runs imports JAX or the JAX package."""
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|flax|iterated_learning_for_vlm_tpu)\b(?!_torch)", re.M)
    for path in BENCH_DIR.rglob("*.py"):
        assert not pattern.search(path.read_text()), path
