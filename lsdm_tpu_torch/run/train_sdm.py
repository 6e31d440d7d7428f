"""Train the SceneDiffusionModel: the port's ``train_sdm`` entry point.

Counterpart of ``lsdm_tpu/run/train_sdm.py`` (reference
``run/train_sdm.py``), with the same flags where the port has the feature:

    python -m lsdm_tpu_torch.run.train_sdm --train_data_dir D/proxd_train \\
        [--valid_data_dir D/proxd_valid] [--objs_data_dir D/objs] \\
        [--save_dir training_output] [--epochs N] [--batch_size 6] \\
        [--ball_impl auto|pallas|topk|sg] [--attn_impl auto|xla|pallas] \\
        [--load_ckpt ckpt.pt] [--device cuda]

On CUDA ``--ball_impl auto`` runs the selection kernels (K1, K2, K3) and
``--attn_impl auto`` resolves to the rank-1 attention pair (K4, K5)
(``models/sampling.py:resolve_train_attn_impl``); ``--ball_impl sg``
adds K10.
The K11 chamfer loss (``chamfer_impl="pallas"``) is an argument of
``train/trainer.py:make_train_step``, as in the JAX package, whose train
CLI has no flag for it.  ``--device`` defaults to ``cuda`` and there is
no silent CPU run: without a GPU the CLI refuses unless ``--device cpu``
is given.  Checkpoints are reference ``.pt`` files (``train/checkpoint.py``),
which the port's ``run/test_sdm.py --load_model`` and the JAX package's
``load_torch_checkpoint`` read.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional, Sequence

import torch

# flags of the JAX CLI whose feature the port does not have (ROADMAP.md)
_NOT_PORTED = {
    "mesh": "multi-GPU training is ROADMAP.md queue 1 item 15",
    "steps_per_dispatch": "a TPU dispatch workaround (ROADMAP.md, 'Not ported')",
    "sa_hoist": "a TPU-only formulation (ROADMAP.md, 'Not ported')",
    "gather_bwd": "one-hot matmul gathers are a TPU workaround (ROADMAP.md, "
                  "'Not ported'); the port's gathers are exact",
}


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--train_data_dir", required=True)
    ap.add_argument("--valid_data_dir", default=None)
    ap.add_argument("--objs_data_dir", default=None)
    ap.add_argument("--save_dir", default="training_output")
    ap.add_argument("--datatype", default="proxd", choices=["proxd", "humanise"])
    ap.add_argument("--epochs", type=int, default=1000)
    ap.add_argument("--batch_size", type=int, default=6)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--eval_every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--text_encoder", default="auto",
                    choices=["auto", "CLIP", "BERT", "HASH"],
                    help="'auto' = CLIP when a BPE merges source exists, else "
                         "HASH; only HASH is ported")
    ap.add_argument("--load_ckpt", default=None,
                    help="resume from a .pt checkpoint this CLI wrote")
    ap.add_argument("--ema_rate", type=float, default=0.0,
                    help="parameter EMA rate (0 = off)")
    ap.add_argument("--lr_anneal_steps", type=int, default=0,
                    help="linear LR anneal horizon (0 = constant)")
    ap.add_argument("--diffusion_steps", type=int, default=1000)
    ap.add_argument("--noise_schedule", default="cosine")
    ap.add_argument("--pcd_points", type=int, default=None,
                    help="override the cloud size (tiny smoke runs)")
    ap.add_argument("--ball_impl", default="auto",
                    choices=["auto", "pallas", "topk", "sg"],
                    help="'auto' = the selection kernels on CUDA, their plain "
                         "versions on the CPU; 'sg' = the select-gather kernel "
                         "K10 in the SA stages")
    ap.add_argument("--attn_impl", default="auto", choices=["auto", "xla", "pallas"],
                    help="train-time pcd_attention: 'pallas' = K4 forward and "
                         "K5 backward; 'auto' = pallas on CUDA, xla on the CPU")
    ap.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"],
                    help="only float32 is ported (bf16 is a later slice)")
    ap.add_argument("--mesh", default=None)
    ap.add_argument("--steps_per_dispatch", type=int, default=1)
    ap.add_argument("--sa_hoist", action="store_true")
    ap.add_argument("--gather_bwd", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' must be asked for explicitly")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None):
    """Train; returns the final ``TrainState``."""
    args = parse_args(argv)
    given = {"mesh": args.mesh is not None,
             "steps_per_dispatch": args.steps_per_dispatch != 1,
             "sa_hoist": args.sa_hoist, "gather_bwd": args.gather_bwd is not None}
    for flag, why in _NOT_PORTED.items():
        if given[flag]:
            raise SystemExit(f"--{flag} is not ported: {why}")
    if args.dtype != "float32":
        raise SystemExit("--dtype bfloat16 is not ported: bf16 autocast is a "
                         "later slice (ROADMAP.md queue 1 item 8)")
    if args.load_ckpt and not args.load_ckpt.endswith(".pt"):
        raise SystemExit(f"--load_ckpt {args.load_ckpt}: only .pt checkpoints "
                         "load into the port")
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("train_sdm: no CUDA device; pass --device cpu to run "
                         "on the CPU")

    from lsdm_tpu_torch import config as cfg_lib
    from lsdm_tpu_torch.data.dataset import DataLoader, Humanise, ProxDatasetTxt
    from lsdm_tpu_torch.models.sampling import resolve_train_attn_impl
    from lsdm_tpu_torch.models.text import TextEncoder, resolve_text_encoder
    from lsdm_tpu_torch.train.checkpoint import load_checkpoint
    from lsdm_tpu_torch.train.trainer import Trainer

    model_cfg = (cfg_lib.sdm_proxd() if args.datatype == "proxd"
                 else cfg_lib.sdm_humanise())
    if args.pcd_points:
        model_cfg = dataclasses.replace(
            model_cfg, pcd_points=args.pcd_points,
            vert_dims=min(model_cfg.vert_dims, args.pcd_points))
    model_cfg = dataclasses.replace(
        model_cfg, ball_impl=args.ball_impl,
        attn_impl=resolve_train_attn_impl(args.attn_impl, dev))
    diff_cfg = cfg_lib.DiffusionConfig(steps=args.diffusion_steps,
                                       noise_schedule=args.noise_schedule)
    train_cfg = cfg_lib.TrainConfig(
        lr=args.lr, epochs=args.epochs, eval_every=args.eval_every,
        ema_rate=args.ema_rate, lr_anneal_steps=args.lr_anneal_steps)

    ds_cls = ProxDatasetTxt if args.datatype == "proxd" else Humanise
    objs_kw = {"objs_data_dir": args.objs_data_dir} if args.objs_data_dir else {}
    train_ds = ds_cls(args.train_data_dir, max_cats=model_cfg.max_cats,
                      pnt_size=model_cfg.pcd_points, **objs_kw)
    train_loader = DataLoader(train_ds, args.batch_size, shuffle=True,
                              seed=args.seed, drop_last=True)
    valid_loader = None
    if args.valid_data_dir:
        valid_ds = ds_cls(args.valid_data_dir, max_cats=model_cfg.max_cats,
                          pnt_size=model_cfg.pcd_points, **objs_kw)
        valid_loader = DataLoader(valid_ds, args.batch_size, shuffle=False)

    text_encoder = TextEncoder(resolve_text_encoder(args.text_encoder),
                               dim=model_cfg.clip_dim)
    trainer = Trainer(model_cfg, diff_cfg, train_cfg, text_encoder=text_encoder,
                      save_dir=args.save_dir, device=dev)
    trainer.init_state(args.seed)
    if args.load_ckpt:
        extra = load_checkpoint(args.load_ckpt, trainer.state)
        print(f"resumed from {args.load_ckpt} at step {trainer.state.step}: {extra}")
    print(f"train_sdm on {dev}: {len(train_ds)} sequences, bs={args.batch_size}, "
          f"{args.epochs} epochs, ball_impl={model_cfg.ball_impl}, "
          f"attn_impl={model_cfg.attn_impl}")
    return trainer.fit(train_loader, valid_loader, epochs=args.epochs,
                       seed=args.seed)


if __name__ == "__main__":
    main()
