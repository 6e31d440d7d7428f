"""A configuration, a traffic mix and a per-layer metric added to a copy of
the benchmark as new files and entries alone are found by their names and
run, with no file of the harness edited."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

from perfbench.tests.conftest import REPO, make_tiny_root


def test_new_files_are_found_by_name(tmp_path):
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copytree(REPO / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    make_tiny_root_keep = root / "tiny"
    make_tiny_root_keep.mkdir()
    make_tiny_root(make_tiny_root_keep)
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    # a new configuration: the tiny float32 one under its own name and file
    cfg = json.loads((make_tiny_root_keep / "perfbench/configs/sdm_proxd_fp32/config.json").read_text())
    cfg["name"] = "sdm_tiny"
    (root / "perfbench/configs/sdm_tiny").mkdir()
    (root / "perfbench/configs/sdm_tiny/config.json").write_text(json.dumps(cfg))
    spec["configs"].append({"name": "sdm_tiny", "source": "https://arxiv.org/abs/2310.15948",
                            "file": "perfbench/configs/sdm_tiny/config.json", "reduced": [],
                            "why": "test"})
    # a new traffic mix: three scenes a request
    tr = json.loads((make_tiny_root_keep / "perfbench/traffic/sample_b1.json").read_text())
    tr["batch"] = 3
    (root / "perfbench/traffic/sample_b3.json").write_text(json.dumps(tr))
    spec["workloads"].append({"name": "tiny.sample_b3", "config": "sdm_tiny",
                              "traffic": "sample_b3", "chips": 1, "why": "test"})
    # a new per-layer metric with its reader
    (root / "perfbench/metrics/scenes_done.py").write_text(
        "def read(run):\n    return float(run.scenes)\n")
    spec["per_layer"].append({"name": "scenes_done.b3", "unit": "scenes", "better": "higher",
                              "source": "program_counter", "layer": "entry",
                              "moves": "sample_scenes_per_s", "workloads": ["tiny.sample_b3"]})
    spec["end_to_end"][0]["workloads"].append("tiny.sample_b3")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    code = f"""
import json, sys
sys.path[:0] = [{str(root)!r}, {str(REPO)!r}]
import torch
from perfbench import harness
assert harness.__file__.startswith({str(root)!r}), harness.__file__
spec = harness.Spec()
for trace in (False, True):
    result, _ = harness.run_cell(spec, "tiny.sample_b3", 23, 0.2, trace, torch.device("cpu"), 0.0)
    print(json.dumps(result))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, check=True)
    plain, traced = (json.loads(line) for line in out.stdout.strip().splitlines()[-2:])
    assert plain["correct"] and traced["correct"]
    assert set(plain["metrics"]) == {"sample_scenes_per_s", "setup_s"}
    assert traced["metrics"]["scenes_done.b3"]["value"] == 3.0 * traced["attempted"]
