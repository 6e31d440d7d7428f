"""On the card: each configuration's control comes out not correct at the
cells' widths, where the program comes out correct.  The size is one a test
run holds: one scene a request, 50 diffusion steps, two checked requests;
the train cell at its batch of 6.

    python -m pytest -m cuda perfbench/tests/test_bench_cuda.py
"""

from __future__ import annotations

import json

import pytest

from perfbench import harness
from perfbench.tests.conftest import REPO

pytestmark = pytest.mark.cuda

STEPS = 50


def _root(tmp_path):
    import shutil

    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "perfbench" / "configs", tmp_path / "perfbench" / "configs")
    shutil.copytree(REPO / "perfbench" / "traffic", tmp_path / "perfbench" / "traffic")
    for f in (tmp_path / "perfbench" / "configs").glob("*/config.json"):
        cfg = json.loads(f.read_text())
        cfg["diffusion"]["steps"] = STEPS
        f.write_text(json.dumps(cfg))
    for f in (tmp_path / "perfbench" / "traffic").glob("sample_*.json"):
        tr = json.loads(f.read_text())
        tr.update(batch=1, check_units=2)
        f.write_text(json.dumps(tr))
    return tmp_path


@pytest.mark.parametrize("workload", ["proxd_fp32.sample_b1", "proxd_fp32.train_b6"])
def test_control_fails_where_the_program_passes(tmp_path, cuda_device, workload):
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = harness.Spec(_root(tmp_path))
    for seed in (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103):
        result, run = harness.run_cell(spec, workload, seed, 0.5, False, cuda_device, 0.0)
        assert result["correct"], result["checks"]
        control = run.control()
        limits = {k: c["limit"] for k, c in result["checks"].items()}
        assert any(v > limits[k] for k, v in control.items()), (control, limits)
