"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level names (the port's name begins with the JAX package's), and
the plain reference loads nothing of the program under test."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

from perfbench.tests.conftest import REPO

BANNED = {"jax", "jaxlib", "flax", "lsdm_tpu"}
HARNESS = ["perfbench.run", "perfbench.calibrate", "perfbench.harness", "perfbench.trace",
           "perfbench.traffic", "perfbench.tasks.sample", "perfbench.tasks.train",
           "perfbench.families.sdm"]


def _loaded_after(imports, extra="") -> set:
    code = ("import json, sys\n" + "".join(f"import {m}\n" for m in imports) + extra
            + "print(json.dumps(sorted({n.split('.')[0] for n in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    metrics = [f"perfbench.metrics.{p.stem}" for p in (REPO / "perfbench" / "metrics").glob("*.py")]
    # the port's modules the tasks import when they run
    port = ("import lsdm_tpu_torch.models.sampling, lsdm_tpu_torch.train.trainer, "
            "lsdm_tpu_torch.diffusion.schedule, lsdm_tpu_torch.config\n")
    loaded = _loaded_after(HARNESS + metrics, port)
    assert "lsdm_tpu_torch" in loaded  # the name is compared whole
    assert not loaded & BANNED, loaded & BANNED


def test_reference_loads_nothing_of_the_program():
    loaded = _loaded_after(["perfbench.reference.sdm", "perfbench.reference.sdm_counts"])
    assert not loaded & (BANNED | {"lsdm_tpu_torch"})


def test_reference_sources_import_only_torch_numpy_and_themselves():
    allowed = {"__future__", "dataclasses", "math", "typing", "numpy", "torch", "perfbench"}
    for path in (REPO / "perfbench" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] in allowed, (path.name, name)
                if name.startswith("perfbench"):
                    assert name.startswith("perfbench.reference"), (path.name, name)


def test_run_refuses_without_a_gpu():
    """No CUDA device: exit code 2 and no result line."""
    import torch

    if torch.cuda.is_available():
        return
    proc = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                           "proxd_fp32.sample_b8", "--seed", "5", "--seconds", "1"],
                          cwd=REPO, capture_output=True, text=True)
    assert proc.returncode == 2
    assert not proc.stdout.strip()


def test_benchmark_names_resolve():
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    from perfbench import harness

    for wl in spec["workloads"]:
        cfg = harness.Spec(REPO).config(wl["config"])
        assert (REPO / "perfbench" / "families" / f"{cfg['family']}.py").exists()
        tr = harness.Spec(REPO).traffic(wl["traffic"])
        assert (REPO / "perfbench" / "tasks" / f"{tr['task']}.py").exists()
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(harness.reader(m["name"]))
    assert Path(REPO / spec["command"][1]).exists()
