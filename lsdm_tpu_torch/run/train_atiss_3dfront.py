"""Train ATISS on cached 3D-FRONT rooms: the port's ``train_atiss_3dfront``
entry point.

Counterpart of ``lsdm_tpu/run/train_atiss_3dfront.py``, with its flags:

    python -m lsdm_tpu_torch.run.train_atiss_3dfront --dataset_directory <cache> \\
        --annotation_file splits.csv --train_stats stats.json \\
        [--epochs 10] [--steps_per_epoch 0] [--batch_size 8] [--max_boxes 12] \\
        [--feature_extractor resnet18|alexnet|simple] [--scalar_head] \\
        [--save_dir training_output] [--device cuda]

Rooms flow through the port's copy of the 3D-FRONT encoding chain
(``data/threed_front_dataset.py``: cached rooms, class-frequency ordering,
[-1, 1] scaling, permutation, the autoregressive WOCM split), collated to
``--max_boxes`` fixed slots with a validity mask; the loss is ATISS's
class cross-entropy plus DMLL (MSE with ``--scalar_head``) on the split box
(JAX ``train_atiss_3dfront.py:117-139``), one ``torch.optim.AdamW`` update a
batch with weight decay 0 (``optax.adamw(lr, weight_decay=0.0)``).  The host
draws are JAX's: ``np.random.seed(seed)`` before the dataset is built (the
augmentations draw from it; the first batch that JAX's trainer builds to
initialise its model is built here too), then ``RandomState(seed)`` for
the batch indices.  The model stays in eval mode, as JAX's ``apply`` runs
it, and its forward and backward run under ``cudnn_full_fp32`` (cuDNN would
take the ResNet18 extractor's convolutions in TF32).  Checkpoints are the
port's ``.pt`` (``best_model_3dfront.pt``, ``final_3dfront.pt``) with the
graph's flags beside the weights; ``--device`` is cuda unless ``cpu`` is
asked for, and ``--platform`` is refused.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from lsdm_tpu_torch.run import jax_flags


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataset_directory", required=True)
    ap.add_argument("--annotation_file", required=True)
    ap.add_argument("--train_stats", default="dataset_stats.txt")
    ap.add_argument("--room_layout_size", default="64,64")
    ap.add_argument("--box_ordering", default=None,
                    choices=[None, "class_frequencies"])
    ap.add_argument("--max_boxes", type=int, default=12)
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--steps_per_epoch", type=int, default=0,
                    help="0 = one pass over the split")
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--n_layers", type=int, default=4)
    ap.add_argument("--n_heads", type=int, default=8)
    ap.add_argument("--dim_ff", type=int, default=1024)
    ap.add_argument("--n_mixtures", type=int, default=4)
    ap.add_argument("--scalar_head", action="store_true",
                    help="LSDM-fork scalar heads + MSE instead of DMLL")
    ap.add_argument("--feature_extractor", default="resnet18",
                    choices=["simple", "resnet18", "alexnet"])
    ap.add_argument("--save_dir", default="training_output")
    ap.add_argument("--seed", type=int, default=0)
    jax_flags.add_device(ap)
    return ap.parse_args(argv)


def make_boxes(enc, samples, n_classes: int, max_boxes: int,
               device) -> Dict[str, torch.Tensor]:
    """The encoded rooms' collate, cut or padded to ``max_boxes`` slots with
    a ``valid_mask`` (JAX ``train_atiss_3dfront.py:84-106``), on ``device``."""
    batch = enc.collate_fn(samples)
    B, L = batch["class_labels"].shape[:2]
    K, C = max_boxes, n_classes
    out = {"class_labels": np.zeros((B, K, C), np.float32),
           "translations": np.zeros((B, K, 3), np.float32),
           "sizes": np.zeros((B, K, 3), np.float32),
           "angles": np.zeros((B, K, 1), np.float32),
           "valid_mask": np.zeros((B, K), np.float32)}
    n = min(L, K)
    for k in ("class_labels", "translations", "sizes", "angles"):
        out[k][:, :n] = batch[k][:, :n]
    for i, length in enumerate(batch["lengths"].astype(int)):
        out["valid_mask"][i, :min(length, K)] = 1.0
    out["room_layout"] = batch["room_layout"]
    for k in ("class_labels_tr", "translations_tr", "sizes_tr", "angles_tr"):
        out[k] = batch[k]
    return {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
            for k, v in out.items()}


def loss_fn(model, boxes: Dict[str, torch.Tensor], scalar_head: bool) -> torch.Tensor:
    """Class cross-entropy against the split box's one-hot class, plus the
    DMLL (or, with the scalar head, the MSE) of its seven properties
    (JAX ``train_atiss_3dfront.py:117-139``)."""
    from lsdm_tpu_torch.models.atiss import dmll

    out = model(boxes)
    cls_tr = boxes["class_labels_tr"][:, 0]
    ce = -(cls_tr * torch.log_softmax(out.class_labels[:, 0], dim=-1)).sum(-1).mean()
    tr, sz = boxes["translations_tr"], boxes["sizes_tr"]
    props = [(out.translations_x, tr[..., 0:1]), (out.translations_y, tr[..., 1:2]),
             (out.translations_z, tr[..., 2:3]), (out.sizes_x, sz[..., 0:1]),
             (out.sizes_y, sz[..., 1:2]), (out.sizes_z, sz[..., 2:3]),
             (out.angles, boxes["angles_tr"])]
    if scalar_head:
        return ce + sum(torch.mean((p[:, 0] - t[:, 0]) ** 2) for p, t in props)
    return ce + sum(dmll(p, t) for p, t in props)


def train_step(state, boxes: Dict[str, torch.Tensor], scalar_head: bool) -> torch.Tensor:
    """One AdamW update of ``state`` on one batch, forward and backward in
    full float32 on cuDNN; returns the loss."""
    from lsdm_tpu_torch.models.cudnn import cudnn_full_fp32
    from lsdm_tpu_torch.train.state import apply_gradients

    state.optimizer.zero_grad(set_to_none=True)
    with cudnn_full_fp32():
        loss = loss_fn(state.model, boxes, scalar_head)
        loss.backward()
    apply_gradients(state)
    return loss.detach()


def main(argv: Optional[Sequence[str]] = None):
    """Train; returns the final train state."""
    args = parse_args(argv)
    dev = jax_flags.device(args, "train_atiss_3dfront")

    from lsdm_tpu_torch.data.threed_front_dataset import get_dataset_raw_and_encoded
    from lsdm_tpu_torch.models.atiss import AutoregressiveTransformer, model_flags
    from lsdm_tpu_torch.run._baseline_common import FLAGS_KEY
    from lsdm_tpu_torch.train.checkpoint import save_checkpoint
    from lsdm_tpu_torch.train.state import create_train_state
    from lsdm_tpu_torch.utils.logger import KVLogger
    from lsdm_tpu_torch.weights import init_weights

    config = {
        "dataset_type": "cached_threedfront",
        "encoding_type": "cached_autoregressive_wocm",
        "dataset_directory": args.dataset_directory,
        "annotation_file": args.annotation_file,
        "train_stats": args.train_stats,
        "room_layout_size": args.room_layout_size,
        "box_ordering": args.box_ordering,
    }
    np.random.seed(args.seed)  # the encodings' augmentations draw from it
    raw, enc = get_dataset_raw_and_encoded(config, split=["train", "val"])
    C = len(raw.class_labels)
    print(f"{len(enc)} rooms, {C} classes (incl. start/end)")

    model = AutoregressiveTransformer(
        n_classes=C, n_layers=args.n_layers, n_heads=args.n_heads,
        dim_ff=args.dim_ff, n_mixtures=args.n_mixtures,
        scalar_head=args.scalar_head,
        feature_extractor_name=args.feature_extractor)
    # eval mode throughout: JAX's apply runs the model with train=False
    model = init_weights(model, args.seed).to(dev).eval()
    # JAX's trainer builds one batch to initialise its model; its samples'
    # draws are taken here too, so the epochs see the same rooms
    make_boxes(enc, [enc[i] for i in range(min(args.batch_size, len(enc)))], C,
               args.max_boxes, dev)
    state = create_train_state(model, lr=args.lr, weight_decay=0.0)
    os.makedirs(args.save_dir, exist_ok=True)
    logger = KVLogger(os.path.join(args.save_dir, "logs"))
    meta = {"kind": "atiss_3dfront", "n_classes": C, FLAGS_KEY: model_flags(model)}

    rng = np.random.RandomState(args.seed)
    steps = args.steps_per_epoch or max(len(enc) // args.batch_size, 1)
    best = float("inf")
    for epoch in range(args.epochs):
        total = 0.0
        for _ in range(steps):
            idxs = rng.randint(0, len(enc), size=args.batch_size)
            boxes = make_boxes(enc, [enc[i] for i in idxs], C, args.max_boxes, dev)
            total += float(train_step(state, boxes, args.scalar_head))
        mean = total / steps
        logger.log("train/loss", mean, step=epoch)
        print(f"epoch {epoch}: loss {mean:.4f}")
        if mean < best:
            best = mean
            save_checkpoint(os.path.join(args.save_dir, "best_model_3dfront.pt"),
                            state, extra={"epoch": epoch, "loss": mean, **meta})
    save_checkpoint(os.path.join(args.save_dir, "final_3dfront.pt"), state,
                    extra={"epoch": args.epochs - 1, **meta})
    logger.close()
    return state


if __name__ == "__main__":
    main()
