"""The plain reference against the port's CPU path, through the harness at a
tiny size: the sampling cells (float32 and bf16) and the train cell come
out correct, with every number well inside its limit, in both kinds of run."""

from __future__ import annotations

import json

import pytest
import torch

from perfbench import harness

CELLS = ["proxd_fp32.sample_b8", "proxd_fp32.train_b6", "proxd_fp32.sample_b1",
         "proxd_bf16.sample_b8"]


def _with_bf16_cell(root):
    """The bf16 configuration's sampling cell, which ``BENCHMARK.json``
    leaves out for now, added to a copy so that the reference's bf16 path
    stays held to the port's."""
    path = root / "BENCHMARK.json"
    spec = json.loads(path.read_text())
    if not any(w["name"] == "proxd_bf16.sample_b8" for w in spec["workloads"]):
        spec["configs"].append({"name": "sdm_proxd_bf16", "source": "-", "reduced": [], "why": "-",
                                "file": "perfbench/configs/sdm_proxd_bf16/config.json"})
        spec["workloads"].append({"name": "proxd_bf16.sample_b8", "config": "sdm_proxd_bf16",
                                  "traffic": "sample_b8", "chips": 1, "why": "-"})
        spec["end_to_end"][0]["workloads"].append("proxd_bf16.sample_b8")
        path.write_text(json.dumps(spec))
    return root


@pytest.mark.parametrize("workload", CELLS)
def test_cell_is_correct_on_the_cpu(tiny_root, workload):
    spec = harness.Spec(_with_bf16_cell(tiny_root))
    result, run = harness.run_cell(spec, workload, 2 ** 40 + 3, 0.2, False,
                                   torch.device("cpu"), 0.0)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 1
    for name, c in result["checks"].items():
        assert c["value"] <= c["limit"] / 10, (name, c)
    names = {m["name"] for m in spec.metrics_for(workload, False)}
    assert set(result["metrics"]) == names
    assert list(result)[-1] == "checks"


def test_traced_run_on_the_cpu_reports_no_device_numbers(tiny_root):
    """The CPU has no device trace: the readers of device numbers find
    nothing and the harness leaves them out; the host's encode span stays."""
    spec = harness.Spec(tiny_root)
    result, _ = harness.run_cell(spec, "proxd_fp32.sample_b1", 17, 1.0, True,
                                 torch.device("cpu"), 0.0)
    assert result["correct"]
    assert set(result["metrics"]) == {"encode_ms.b1", "sample_mfu.b1"}
    assert result["device"]["busy_s"] == 0.0


def test_same_seed_same_inputs(tiny_root):
    from perfbench import traffic

    spec = harness.Spec(tiny_root)
    cfg, tr = spec.config("sdm_proxd_fp32"), spec.traffic("sample_b8")
    a = traffic.scenes(cfg, tr, 2 ** 33 + 1, 5, torch.device("cpu"))
    b = traffic.scenes(cfg, tr, 2 ** 33 + 1, 5, torch.device("cpu"))
    c = traffic.scenes(cfg, tr, 2 ** 33 + 1, 6, torch.device("cpu"))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["objs"], c["objs"])
    given = a["mask"].sum(dim=1)
    assert ((given >= tr["given_objects"][0]) & (given <= tr["given_objects"][1])).all()
    assert (a["mask"][:, 0] == 0).all()  # slot 0 is the human
