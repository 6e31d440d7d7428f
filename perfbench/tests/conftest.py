"""Shared fixtures of the benchmark's tests: a checkout root whose
configurations and traffic are the benchmark's own, cut to a size the CPU
runs in seconds (64 points, 40 human vertices, 4 diffusion steps, 2 scenes
a request or step).  On the CPU the port's kernel wrappers run their plain
versions; the sampling traffic takes the loop kernel's path
(``fused_step="chain"``), whose plain version computes in the kernel's
precision."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

TINY_MODEL = {"pcd_points": 64, "vert_dims": 40}
TINY_STEPS = 4


def make_tiny_root(dest: Path) -> Path:
    shutil.copy(REPO / "BENCHMARK.json", dest)
    shutil.copytree(REPO / "perfbench" / "configs", dest / "perfbench" / "configs")
    shutil.copytree(REPO / "perfbench" / "traffic", dest / "perfbench" / "traffic")
    for f in (dest / "perfbench" / "configs").glob("*/config.json"):
        cfg = json.loads(f.read_text())
        cfg["model"].update(TINY_MODEL)
        cfg["diffusion"]["steps"] = TINY_STEPS
        f.write_text(json.dumps(cfg))
    for f in (dest / "perfbench" / "traffic").glob("*.json"):
        tr = json.loads(f.read_text())
        tr.update(batch=2, warmup=1, check_units=2, trace_units=2)
        if tr["task"] == "sample":
            tr["fused_step"] = "chain"
        f.write_text(json.dumps(tr))
    return dest


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny_root(tmp_path)


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda", 0)
