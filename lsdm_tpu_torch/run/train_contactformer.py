"""Train the ContactFormer: the port's ``train_contactformer`` entry point.

Counterpart of ``lsdm_tpu/run/train_contactformer.py``, with its flags.
The loss is the masked per-vertex contact cross-entropy plus ``kl_beta``
times the VAE's KL (``train/contact.py``), one Adam update a window of
``ProxContactDataset``.  Without ``mesh_ds/`` assets the mesh levels are
synthetic grids (``data/mesh_assets.py``) and the run says so.  It writes
``SAVE_DIR/best_model_recon_acc.pt`` (+ ``.json``: epoch, loss, acc)
whenever an epoch's mean loss is the lowest yet, and ``SAVE_DIR/logs/``.

    python -m lsdm_tpu_torch.run.train_contactformer --train_data_dir D \\
        [--save_dir training_output] [--epochs 100] [--device cuda]

``--device`` defaults to ``cuda``; without a GPU the CLI raises unless
``--device cpu`` is given.  The weights are seeded with ``--seed``; the
reparameterisation noise comes from one ``torch.Generator`` on the
device, seeded with ``--seed``.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

from lsdm_tpu_torch.run import jax_flags


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--train_data_dir", required=True)
    ap.add_argument("--mesh_ds_dir", default="data/mesh_ds")
    ap.add_argument("--save_dir", default="training_output")
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--steps_per_epoch", type=int, default=0,
                    help="0 = one pass over the dataset")
    ap.add_argument("--decoder_mode", type=int, default=1)
    ap.add_argument("--max_frame", type=int, default=256)
    ap.add_argument("--jump_step", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--kl_beta", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fix_ori", action="store_true")
    jax_flags.add_device(ap)
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Train; returns the last epoch's mean loss and accuracy and the best
    loss."""
    args = parse_args(argv)
    dev = jax_flags.device(args, "train_contactformer")

    import torch

    from lsdm_tpu_torch.data.contact_dataset import ProxContactDataset
    from lsdm_tpu_torch.data.mesh_assets import load_mesh_assets
    from lsdm_tpu_torch.models.contactformer import ContactFormer
    from lsdm_tpu_torch.train.checkpoint import save_checkpoint
    from lsdm_tpu_torch.train.contact import contact_train_step
    from lsdm_tpu_torch.train.state import TrainState
    from lsdm_tpu_torch.utils.logger import KVLogger
    from lsdm_tpu_torch.weights import init_weights

    ds = ProxContactDataset(
        args.train_data_dir, fix_orientation=args.fix_ori,
        max_frame=args.max_frame, jump_step=args.jump_step, seed=args.seed,
    )
    # two draws before training, as the JAX trainer makes them (the vertex
    # count, then its init sample), so the epochs see the same windows
    V = ds[0][0].shape[1]
    ds[0]
    assets = load_mesh_assets(
        args.mesh_ds_dir, nv_override=(V, max(V // 4, 2), max(V // 16, 1)),
        device=dev)
    if assets.synthetic:
        print(f"WARNING: mesh_ds assets not found; synthetic graph nv={assets.nv}")

    model = ContactFormer(assets.spiral_indices, assets.down_mats,
                          seg_len=args.max_frame, decoder_mode=args.decoder_mode)
    model = init_weights(model, args.seed).to(dev).train()
    optimizer = torch.optim.Adam(model.parameters(), lr=args.lr)
    state = TrainState(model=model, optimizer=optimizer, lr=args.lr)
    logger = KVLogger(os.path.join(args.save_dir, "logs"))
    os.makedirs(args.save_dir, exist_ok=True)
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    def put(a):
        return torch.from_numpy(a).to(dev)

    steps = args.steps_per_epoch or len(ds)
    best = float("inf")
    for epoch in range(args.epochs):
        tot, tot_acc = 0.0, 0.0
        for i in range(steps):
            vc, cs, m = ds[i]
            loss, _, acc = contact_train_step(model, optimizer, put(cs), put(vc),
                                              put(m)[None], args.kl_beta,
                                              generator=gen)
            state.step += 1
            state.updates += 1
            tot += float(loss)
            tot_acc += float(acc)
        mean, mean_acc = tot / steps, tot_acc / steps
        logger.log("train/loss", mean, step=epoch)
        logger.log("train/recon_acc", mean_acc, step=epoch)
        print(f"epoch {epoch}: loss {mean:.4f} acc {mean_acc:.4f}")
        if mean < best:
            best = mean
            save_checkpoint(
                os.path.join(args.save_dir, "best_model_recon_acc.pt"), state,
                extra={"epoch": epoch, "loss": mean, "acc": mean_acc})
    logger.close()
    return {"loss": mean, "acc": mean_acc, "best_loss": best}


if __name__ == "__main__":
    main()
