"""Rank-side work of ``tests/test_torch_parallel.py``, in a module without JAX:
the ranks are new processes, which import this module to find the
function they run."""

import torch

from lsdm_tpu_torch.diffusion import gaussian
from lsdm_tpu_torch.parallel import dryrun
from lsdm_tpu_torch.train import trainer


def float64_losses(schedule, model_fn, x_start, t, target_cat, noise,
                   lambda_cat=0.1, chamfer_impl="xla"):
    """``training_losses`` without its float32 cast of the chamfer's inputs
    (JAX's ``astype(float32)``), so that a float64 step is float64 end to
    end: in float32 the two batch means (one over the batch, one over each
    rank's rows, then summed) round apart by ~1e-8."""
    x_t = gaussian.q_sample(schedule, x_start, t, noise)
    out = model_fn(x_t, t)
    log_probs = torch.log_softmax(out.cat[:, 0], dim=-1)
    cat_loss = lambda_cat * -log_probs.gather(1, target_cat.argmax(dim=1)[:, None]).mean()
    d = ((out.x0[:, :, None] - x_start[:, None]) ** 2).sum(-1)
    mse = (d.min(2).values.mean(1) + d.min(1).values.mean(1)).mean()
    return {"loss": mse + cat_loss, "mse": mse, "cat_loss": cat_loss}


def worker(rank, cfg_kw, weights, inputs, draws, sample_args):
    """Every check of the file on one rank, in one spawn: the float32 and
    float64 steps at 2x1, 1x2 and 2x2, the float64 step of a DGCNN + P2R
    model at 2x2, the float64 step with a planted fault (``dryrun.planted``:
    the mask read per rank at 2x1, the gradients counted per model rank at
    1x2), and the sharded sample at 4x1."""
    meshes = [(2, 1), (1, 2), (2, 2)]
    kw = dict(weights=weights, inputs=inputs, draws=draws)
    out = {"float32": dryrun.train_check(rank, cfg_kw, meshes, "float32", **kw)}
    saved = trainer.training_losses
    trainer.training_losses = float64_losses
    try:
        out["float64"] = dryrun.train_check(rank, cfg_kw, meshes, "float64", **kw)
        # the alternate backbones: DGCNN's two keep-masks and its two
        # BatchNorms over the mesh, the P2R tower's over the data axis
        # (seeded weights and draws: the converted ones are PointNet++'s)
        out["float64_alt"] = dryrun.train_check(
            rank, dict(cfg_kw, pcd_backbone_type="DGCNN", human_backbone_type="P2R"),
            [(2, 2)], "float64", inputs=inputs)
        out["faults"] = dryrun.train_check(
            rank, cfg_kw, [(2, 1, "local_mask"), (1, 2, "model_axis")], "float64", **kw)
    finally:
        trainer.training_losses = saved
    out["sample"] = dryrun.sample_check(rank, cfg_kw, (4, 1), **sample_args)
    return out
