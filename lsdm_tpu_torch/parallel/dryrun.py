"""The sharded train step and sharded sampling against their single-process
forms, on ranks of one machine: the checks that ``chip_smoke.py`` and
``tests/test_torch_parallel.py`` run in each rank (started with
``parallel.mesh.spawn``), the counterpart of the JAX package's
``__graft_entry__.py:dryrun_multichip``.

Each rank builds the same seeded model (or takes given weights) and the
same global batch, whose object masks differ from scene to scene (the SDM
reads them across the batch axis), and the same draws.  :func:`train_check`
runs the single-process step on the whole batch, then, for every mesh,
the step of ``train/trainer.py:make_train_step(mesh=...)`` from the same
start: its loss, its gradients and parameters against the single-process
ones, a digest of its parameters and statistics (equal digests: bitwise
equal ranks) and the kernel launches of the sharded step alone
(``kernels.LAUNCHES`` is per process).  A mesh may carry a planted fault
(:func:`planted`), to show that the checks see one.  :func:`sample_check`
samples the global batch on one process and over a data-axis mesh from
the same draws.  On ``cuda`` each rank takes card ``rank % device_count``:
with one card per rank the backend is NCCL, and ranks that share a card
use gloo (its CUDA all-reduce, broadcast and all-gather stage through the
host).
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import hashlib
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from lsdm_tpu_torch import kernels
from lsdm_tpu_torch.config import SDMConfig
from lsdm_tpu_torch.diffusion.schedule import make_schedule
from lsdm_tpu_torch.models.sampling import (
    resolve_fast_path, resolve_train_attn_impl, sample_sdm)
from lsdm_tpu_torch.models.sdm import SceneDiffusionModel
from lsdm_tpu_torch.parallel.mesh import (
    BatchShard, make_mesh, rank_device, sharded_config)
from lsdm_tpu_torch.train import trainer
from lsdm_tpu_torch.train.state import create_train_state
from lsdm_tpu_torch.weights import init_weights

# the parameter check's entries: a gradient of at least 100 x Adam's eps
# (see train_check)
WELL_CONDITIONED = 100 * 1e-8
TINY = dict(clip_dim=32, latent_dim=16, cat_emb=8, n_head=4, vert_dims=24,
            pcd_points=32)


def scene_inputs(cfg: SDMConfig, batch: int, seed: int) -> Dict[str, np.ndarray]:
    """A global batch as numpy arrays: per-scene object masks
    (``mask[b, 1:2 + 3 * b % (O - 1)] = 1``: at O = 9 no two of the first
    8 scenes alike, and in no order a short period would give, so that no
    rank's slice reads the mask as the global batch does by chance, as
    ``b % 3`` does at 3 scenes a rank), clouds, one-hot categories, targets
    and text features, from ``seed``."""
    rs = np.random.RandomState(seed)
    O, N = cfg.max_objs, cfg.pcd_points
    mask = np.zeros((batch, O), np.float32)
    for b in range(batch):
        mask[b, 1:2 + 3 * b % (O - 1)] = 1.0
    eye = np.eye(cfg.max_cats, dtype=np.float32)
    return dict(mask=mask,
                objs=(rs.randn(batch, O, N, 3) * 0.3).astype(np.float32),
                cats=eye[rs.randint(0, cfg.max_cats, (batch, O))],
                target=(rs.randn(batch, N, 3) * 0.2).astype(np.float32),
                target_cat=eye[rs.randint(0, cfg.max_cats, batch)],
                text=rs.randn(batch, cfg.clip_dim).astype(np.float32))


INPUTS = ("mask", "objs", "cats", "target", "target_cat", "text")


def _tensors(arrays: Dict[str, np.ndarray], dev, dtype) -> Dict[str, torch.Tensor]:
    out = {}
    for k, a in arrays.items():
        t = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        out[k] = t.to(dtype) if t.is_floating_point() else t
    return out


def _model(cfg: SDMConfig, weights, seed: int, dev, dtype) -> SceneDiffusionModel:
    model = SceneDiffusionModel(cfg)
    if weights is None:
        init_weights(model, seed)
    else:
        model.load_state_dict({k: torch.as_tensor(v) for k, v in weights.items()})
    return model.to(dev, dtype)


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def digest(module: torch.nn.Module) -> str:
    """A hash of every parameter's and buffer's bits."""
    h = hashlib.sha256()
    for _, t in sorted(module.state_dict().items()):
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _launches() -> Dict[str, int]:
    return {k: v + kernels.GRAPH_LAUNCHES[k] for k, v in kernels.LAUNCHES.items()}


class LocalMaskShard(BatchShard):
    """A planted fault: a rank that reads the object mask as if its rows
    were the whole batch (local tiling, local scramble), all else
    sharded."""

    def global_mask(self, mask):
        return mask.float()

    def offset(self, local_batch):
        return 0


def _counted_per_model_rank(reduce):
    def reduce_gradients(model, mesh):
        reduce(model, mesh)
        for p in model.parameters():
            if p.grad is not None:
                p.grad.mul_(mesh.shape[1])
    return reduce_gradients


@contextlib.contextmanager
def planted(fault: Optional[str]):
    """The sharded train step with a planted fault, to show what a check
    sees: ``"local_mask"`` (:class:`LocalMaskShard`), or ``"model_axis"``,
    the step without its division by the model axis: every gradient
    counted once for each rank of a model-axis line, as a gather's backward
    sums it there.  None: the step as it is."""
    saved = trainer.BatchShard, trainer.reduce_gradients
    if fault == "local_mask":
        trainer.BatchShard = LocalMaskShard
    elif fault == "model_axis":
        trainer.reduce_gradients = _counted_per_model_rank(saved[1])
    elif fault is not None:
        raise ValueError(f"unknown fault {fault!r}")
    try:
        yield
    finally:
        trainer.BatchShard, trainer.reduce_gradients = saved


def train_check(rank: int, cfg_kw: dict, meshes: Sequence[Tuple],
                dtype: str = "float32", device: str = "cpu", seed: int = 0,
                batch: int = 8, T: int = 8, weights=None, inputs=None,
                draws=None, reps: int = 0) -> dict:
    """One rank's part: the single-process step, then each mesh's sharded
    step from the same weights and draws.  A mesh is ``(data, model)``,
    its result under the label ``"DxM"``, or ``(data, model, fault)``
    with a fault :func:`planted`, under ``"DxM fault"`` (not timed).
    ``draws`` (t, noise, keep as numpy) default to a seeded generator's
    global draws.  ``reps`` > 0 also times that many more steps of each
    (ms/step).  A mesh's ``grad_err`` is the largest over the leaves of
    |sharded - single| / |single| (2-norms, a leaf's floored at a
    thousandth of the largest), ``param_err`` the largest entry of
    |sharded - single| where the single step's gradient is at least
    WELL_CONDITIONED, ``param_err_all`` over every entry."""
    dev = rank_device(device, rank, _world())
    tdt = {"float32": torch.float32, "float64": torch.float64}[dtype]
    cfg = sharded_config(SDMConfig(**cfg_kw))
    # the train CLI's resolution: K4/K5 on CUDA
    cfg = dataclasses.replace(cfg, attn_impl=resolve_train_attn_impl(
        cfg_kw.get("attn_impl", "auto"), dev))
    model0 = _model(cfg, weights, seed, dev, tdt)
    x = _tensors(inputs if inputs is not None
                 else scene_inputs(cfg, batch, seed), dev, tdt)
    batch = x["mask"].shape[0]
    schedule = make_schedule("cosine", T, device=dev)
    if draws is None:
        g = torch.Generator(device=dev).manual_seed(seed + 1)
        d = dict(t=torch.randint(0, T, (batch,), generator=g, device=dev),
                 noise=torch.randn(batch, cfg.pcd_points, 3, generator=g,
                                   device=dev).to(tdt),
                 dropout_mask=trainer.dropout_draws(model0, batch * cfg.max_objs, g, dev))
    else:
        d = {"t": torch.as_tensor(draws["t"]).long().to(dev),
             "noise": torch.as_tensor(draws["noise"]).to(dev, tdt),
             "dropout_mask": torch.as_tensor(draws["keep"]).to(dev)}
    args = [x[k] for k in INPUTS]

    def run(mesh, timed):
        """The step from the start; returns what its first call gave (its
        metrics, launches, digest, parameters and gradients) and, with
        ``reps``, the best ms of that many more calls."""
        state = create_train_state(copy.deepcopy(model0))
        step = trainer.make_train_step(schedule, mesh=mesh)
        _sync(dev)
        kernels.reset_launches()
        metrics = step(state, *args, **d)
        _sync(dev)
        first = {"metrics": {k: float(v) for k, v in metrics.items()},
                 "launches": _launches(), "digest": digest(state.model),
                 "params": {n: p.detach().clone()
                            for n, p in state.model.named_parameters()},
                 "grads": {n: p.grad.detach().clone()
                           for n, p in state.model.named_parameters()}}
        ms = None
        if mesh is None and dist.is_initialized():
            dist.barrier()  # the other ranks idle while one times alone
        if reps and timed:
            sec = []
            for _ in range(reps):
                _sync(dev)
                t0 = time.perf_counter()
                step(state, *args, **d)
                _sync(dev)
                sec.append(time.perf_counter() - t0)
            ms = min(sec) * 1e3
        if mesh is None and dist.is_initialized():
            dist.barrier()
        return {**first, "ms": ms}

    rank0 = not dist.is_initialized() or dist.get_rank() == 0
    single = run(None, rank0)
    ref, grads = single.pop("params"), single.pop("grads")
    # Adam's first step moves an entry by lr * g / (|g| + eps): where |g| is
    # near eps, a rounding of g moves the parameter by a share of the
    # learning rate, so the parameter check takes the entries whose
    # gradient is at least WELL_CONDITIONED (the gradient check takes all)
    cond = {n: g.abs() >= WELL_CONDITIONED for n, g in grads.items()}
    # a leaf whose whole gradient is rounding noise (a conv bias ahead of a
    # train-mode BatchNorm) is held to a thousandth of the largest leaf
    gfloor = 1e-3 * max(float(g.norm()) for g in grads.values())
    out = {"single": single}
    for spec in meshes:
        shape, fault = tuple(spec[:2]), (spec[2] if len(spec) > 2 else None)
        mesh = make_mesh(shape, ranks=range(shape[0] * shape[1]))
        if not mesh.member:
            continue
        with planted(fault):
            got = run(mesh, fault is None)
        new, new_grads = got.pop("params"), got.pop("grads")
        diff = {n: (p - ref[n]).abs() for n, p in new.items()}
        grad_err = {n: float((new_grads[n] - g).norm()) / max(float(g.norm()), gfloor)
                    for n, g in grads.items()}
        out[f"{shape[0]}x{shape[1]}" + (f" {fault}" if fault else "")] = {
            **got, "grad_err": max(grad_err.values()),
            "grad_worst": max(grad_err, key=grad_err.get),
            "param_err_all": max(float(t.max()) for t in diff.values()),
            "param_err": max(float(torch.where(cond[n], t, 0.0).max())
                             for n, t in diff.items()),
            "ill_conditioned": sum(int((~c).sum()) for c in cond.values())}
        del got, new, new_grads, diff
    return out


def sample_check(rank: int, cfg_kw: dict, shape: Tuple[int, int],
                 device: str = "cpu", seed: int = 0, batch: int = 8, T: int = 8,
                 weights=None, inputs=None, x_init=None, noise=None,
                 ball_impl: str = "auto", fused_step: Optional[str] = "auto"
                 ) -> dict:
    """One rank's part: the global batch sampled on this process and over a
    data-axis ``shape`` mesh (``sample_sdm(mesh=...)``) with the same
    draws, on the path ``resolve_fast_path`` gives for the device (on CUDA
    the fused encode and K6's chain; ``ball_impl`` / ``fused_step`` choose
    another, on the CPU the plain versions).  Returns both samples, the sharded
    last step's category probabilities and the launches of the sharded
    sample alone."""
    dev = rank_device(device, rank, _world())
    ball_impl, step = resolve_fast_path(ball_impl, fused_step, dev)
    cfg = dataclasses.replace(SDMConfig(**cfg_kw), ball_impl=ball_impl)
    model = _model(cfg, weights, seed, dev, torch.float32).eval()
    x = _tensors(inputs if inputs is not None
                 else scene_inputs(cfg, batch, seed), dev, torch.float32)
    batch = x["mask"].shape[0]
    schedule = make_schedule("cosine", T, device=dev)
    g = torch.Generator(device=dev).manual_seed(seed + 2)
    x_init = (torch.randn(batch, cfg.pcd_points, 3, generator=g, device=dev)
              if x_init is None else torch.as_tensor(x_init).to(dev))
    noise = (torch.randn(T, batch, cfg.pcd_points, 3, generator=g, device=dev)
             if noise is None else torch.as_tensor(noise).to(dev))
    args = [x[k] for k in ("mask", "objs", "cats", "text")]
    single, last1 = sample_sdm(model, schedule, *args, fused_step=step,
                               x_init=x_init, noise=noise)
    mesh = make_mesh(shape, ranks=range(shape[0] * shape[1]))
    if not mesh.member:
        return {}
    _sync(dev)
    kernels.reset_launches()
    t0 = time.perf_counter()
    sharded, last = sample_sdm(model, schedule, *args, fused_step=step,
                               x_init=x_init, noise=noise, mesh=mesh)
    _sync(dev)
    sec = time.perf_counter() - t0
    return {"single": single.cpu(), "sharded": sharded.cpu(),
            "single_cat": last1.cat.cpu(), "cat": last.cat.cpu(),
            "launches": _launches(), "ms": sec * 1e3, "path": (ball_impl, step)}


def train_and_sample_check(rank: int, train_kw: dict, sample_kw: dict) -> dict:
    """:func:`train_check` then :func:`sample_check` in one rank process."""
    return {"train": train_check(rank, **train_kw),
            "sample": sample_check(rank, **sample_kw)}
