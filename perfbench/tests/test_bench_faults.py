"""A run with the timed path broken underneath comes out not correct: the
harness is driven as a run drives it (the look for a GPU skipped), on the
CPU at a tiny size, once for each fault its cells can have."""

from __future__ import annotations

import pytest
import torch

from perfbench import calibrate, harness
from perfbench.families import sdm as family


def _run(root, workload):
    result, _ = harness.run_cell(harness.Spec(root), workload, 2 ** 36 + 9, 0.2, False,
                                 torch.device("cpu"), 0.0)
    return result


def _wrap_sample(monkeypatch, change):
    inner = family.port_sample

    def port_sample(model, schedule, fused_step, inputs, generator):
        return change(inner, model, schedule, fused_step, inputs, generator)

    monkeypatch.setattr(family, "port_sample", port_sample)


def _plant_half_batch(monkeypatch):
    for name in ("port_trainer", "port_sample"):  # restored after the test
        monkeypatch.setattr(family, name, getattr(family, name))
    calibrate.half_batch(family)


def test_sample_answer_altered(tiny_root, monkeypatch):
    def change(inner, *args):
        sample, last = inner(*args)
        sample = sample.clone()
        sample[0, 0, 0] += 0.01 * float(sample.abs().max())
        return sample, last

    _wrap_sample(monkeypatch, change)
    assert not _run(tiny_root, "proxd_fp32.sample_b8")["correct"]


def test_sample_state_unchanged(tiny_root, monkeypatch):
    """Each denoise step returns its input: the sample is the first image."""
    from lsdm_tpu_torch.ops import denoise

    monkeypatch.setattr(denoise, "denoise_step_plain", lambda x, *a, **k: x)
    assert not _run(tiny_root, "proxd_fp32.sample_b8")["correct"]


@pytest.mark.parametrize("workload", ["proxd_fp32.sample_b8"])
def test_sample_half_batch(tiny_root, monkeypatch, workload):
    """The second half of each batch is left out: its scenes get the first
    half's answers."""
    _plant_half_batch(monkeypatch)
    assert not _run(tiny_root, workload)["correct"]


def test_train_state_unchanged(tiny_root, monkeypatch):
    """The step computes its loss and gradients and updates nothing."""
    from lsdm_tpu_torch.train import trainer

    monkeypatch.setattr(trainer, "apply_gradients", lambda state, ema_rate=0.0: None)
    result = _run(tiny_root, "proxd_fp32.train_b6")
    assert not result["correct"]
    assert result["checks"]["update"]["value"] == pytest.approx(1.0)


def test_train_half_batch(tiny_root, monkeypatch):
    """The loss takes half of each batch, the mean over the rest."""
    _plant_half_batch(monkeypatch)
    assert not _run(tiny_root, "proxd_fp32.train_b6")["correct"]
