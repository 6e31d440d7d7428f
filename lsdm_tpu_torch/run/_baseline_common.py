"""Shared train / eval machinery of the ATISS, MIME and ContactFormer-bridge
baselines (reference ``run/{train,test}_{atiss,mime,cf_atiss}.py``).

Counterpart of ``lsdm_tpu/run/_baseline_common.py``, with its protocol:

  * boxes are the PCA boxes of the given objects' clouds
    (``translate_objs_to_bbox``), the room layout a constant ones mask, the
    ``*_tr`` targets constant ones (``run/train_atiss.py:61-73``);
  * box slots are padded to the dataset's 9 and masked out of attention
    (``valid_mask``; slot 0, the human, always valid);
  * the loss is MSE(sizes) + MSE(translations) + CE(class)
    (``run/train_atiss.py:85-87``), one ``torch.optim.AdamW`` update a
    batch (weight decay 0.01, as ``optax.adamw``, ``train/state.py``);
  * the model is never put in train mode, as the JAX trainer never passes
    ``train=True``: every BatchNorm uses its stored statistics, also under
    ``--no_freeze_bn``, and no dropout runs; the backward runs under
    ``cudnn_full_fp32``;
  * eval turns the predicted box and the target object's box into 1024
    uniform points each (seeds ``bi * 64 + i`` and ``+ 7``) before
    chamfer / EMD / F1, over ``len(set(seq_names))`` rows a batch;
  * MIME adds contact labels, 1 on the human slot
    (``run/train_mime.py:62-65``).

Checkpoints are ``.pt`` in the reference's format (``train/checkpoint.py``),
with the graph flags they need (``models/atiss.py:model_flags``) beside the
weights.  ``--load_model`` takes such a file or a reference ``.pt``;
:func:`resolve_parity_flags` picks the graph for it.  A flax ``.ckpt`` is
refused, for ``--load_model`` and for ``--cf_ckpt``; ``--cf_ckpt`` takes a
ContactFormer ``.pt`` of ``run/train_contactformer.py`` (or a POSA one)
and reads its decoder.  ``--device`` is cuda unless ``cpu`` is asked for;
``--platform`` is refused.
"""

from __future__ import annotations

import argparse
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from lsdm_tpu_torch.run import jax_flags

FLAGS_KEY = "atiss_flags"  # a port checkpoint's graph flags


def boxes_from_batch(batch, num_classes: int, contact: bool = False,
                     device=None) -> Dict[str, torch.Tensor]:
    """A host batch -> the ATISS box dict with its padding mask, on
    ``device``."""
    from lsdm_tpu_torch.ops.geometry import translate_objs_to_bbox

    B, O, N, _ = batch.given_objs.shape
    translations, sizes = translate_objs_to_bbox(batch.given_objs.reshape(B * O, N, 3))
    valid = np.asarray(batch.mask, np.float32).copy()
    valid[:, 0] = 1.0  # slot 0, the human, is a box
    cats = np.asarray(batch.given_cats, np.float32)
    if cats.shape[-1] < num_classes:  # input_dims = num_cats + 7
        cats = np.concatenate(
            [cats, np.zeros((B, O, num_classes - cats.shape[-1]), np.float32)], -1)

    def put(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    def ones(*shape):
        return torch.ones(shape, device=device)

    boxes = {
        "class_labels": put(cats),
        "translations": put(translations.reshape(B, O, 3)),
        "sizes": put(sizes.reshape(B, O, 3)),
        "angles": torch.zeros((B, O, 1), device=device),
        "valid_mask": put(valid),
        "room_layout": ones(B, 1, 64, 64),
        "class_labels_tr": ones(B, 1, num_classes),
        "translations_tr": ones(B, 1, 3),
        "sizes_tr": ones(B, 1, 3),
        "angles_tr": ones(B, 1, 1),
    }
    if contact:
        cl = np.zeros((B, O, 1), np.float32)
        cl[:, 0] = 1.0  # the human slot carries contact (run/train_mime.py:63-64)
        boxes["contact_labels"] = put(cl)
    return boxes


def build_model(kind: str, num_classes: int, args=None):
    """(model, input_dims) for ``kind`` ("atiss", "atiss_pe", "mime",
    "cf_atiss") at the reference widths, the graph flags from ``args``."""
    from lsdm_tpu_torch.models.atiss import (
        MIME, AutoregressiveTransformer, AutoregressiveTransformerPE)

    input_dims = num_classes + 7  # reference run/train_atiss.py:289-291
    kw = {} if args is None else graph_kwargs(args)
    if kind == "mime":
        return MIME(input_dims, **kw), input_dims
    if kind == "atiss_pe" or getattr(args, "pe", False):
        return AutoregressiveTransformerPE(input_dims, **kw), input_dims
    return AutoregressiveTransformer(input_dims, **kw), input_dims


def graph_kwargs(args) -> Dict[str, Any]:
    """The model's graph flags from the CLI's (after
    :func:`resolve_parity_flags`)."""
    return dict(feature_extractor_name=getattr(args, "feature_extractor", None)
                or "simple",
                freeze_bn=not getattr(args, "no_freeze_bn", False),
                torch_seq_axis_quirk=bool(getattr(args, "torch_seq_axis_quirk", False)))


def baseline_loss(model, boxes, gt_translation: torch.Tensor, gt_size: torch.Tensor,
                  target_cat: torch.Tensor) -> torch.Tensor:
    """MSE(sizes) + MSE(translations) + CE(class) of one batch
    (``lsdm_tpu/run/_baseline_common.py:135-158``)."""
    out = model(boxes)
    pred_sizes = torch.cat([out.sizes_x, out.sizes_y, out.sizes_z], -1)[:, 0]
    pred_tr = torch.cat([out.translations_x, out.translations_y,
                         out.translations_z], -1)[:, 0]
    logp = torch.log_softmax(out.class_labels[:, 0], dim=-1)
    ce = -torch.mean(logp.gather(1, target_cat.argmax(-1)[:, None]))
    return (torch.mean((pred_sizes - gt_size) ** 2)
            + torch.mean((pred_tr - gt_translation) ** 2) + ce)


def baseline_step(state, boxes, gt_translation, gt_size, target_cat) -> torch.Tensor:
    """One AdamW update of ``state`` on one batch; returns the loss."""
    from lsdm_tpu_torch.models.cudnn import cudnn_full_fp32
    from lsdm_tpu_torch.train.state import apply_gradients

    state.optimizer.zero_grad(set_to_none=True)
    loss = baseline_loss(state.model, boxes, gt_translation, gt_size, target_cat)
    with cudnn_full_fp32():
        loss.backward()
    apply_gradients(state)
    return loss.detach()


def _datasets(args, data_dir: str):
    from lsdm_tpu_torch import config as cfg_lib
    from lsdm_tpu_torch.data.dataset import Humanise, ProxDatasetTxt

    num_cats = cfg_lib.num_cats_for(args.datatype)
    ds_cls = ProxDatasetTxt if args.datatype == "proxd" else Humanise
    kw = {"objs_data_dir": args.objs_data_dir} if args.objs_data_dir else {}
    return ds_cls(data_dir, max_cats=num_cats, **kw), num_cats


def train_baseline(args, kind: str):
    """Train ``kind`` on ``args.train_data_dir``; writes
    ``best_model_{kind}.pt`` and ``final_{kind}.pt`` under ``save_dir``.
    Returns the train state."""
    from lsdm_tpu_torch.data.dataset import DataLoader
    from lsdm_tpu_torch.models.atiss import model_flags
    from lsdm_tpu_torch.ops.geometry import translate_objs_to_bbox
    from lsdm_tpu_torch.train.checkpoint import save_checkpoint
    from lsdm_tpu_torch.train.state import create_train_state
    from lsdm_tpu_torch.utils.logger import KVLogger
    from lsdm_tpu_torch.weights import init_weights

    dev = jax_flags.device(args, f"train_{kind}")
    resolve_parity_flags(args)
    train_ds, num_cats = _datasets(args, args.train_data_dir)
    loader = DataLoader(train_ds, args.batch_size, shuffle=True, seed=args.seed,
                        drop_last=True)
    model, input_dims = build_model(kind, num_cats, args)
    # eval mode throughout: the JAX trainer never passes train=True
    model = init_weights(model, args.seed).to(dev).eval()
    contact = kind == "mime"
    bridge = _make_bridge(args, None, input_dims, dev) if kind == "cf_atiss" else None
    # the JAX trainer inits its model on one batch: that batch's shuffle
    # and the bridge's draws for it are taken here too, so the epochs see
    # the same batches and boxes
    b0 = next(iter(loader))
    if bridge is not None:
        bridge.make_boxes(b0.given_objs, b0.given_cats, b0.mask)
    state = create_train_state(model, lr=args.lr, weight_decay=0.01)
    logger = KVLogger(os.path.join(args.save_dir, "logs"))
    os.makedirs(args.save_dir, exist_ok=True)
    meta = {"kind": kind, FLAGS_KEY: model_flags(model)}

    def put(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    best = float("inf")
    for epoch in range(args.epochs):
        total, n = 0.0, 0
        for batch in loader:
            if bridge is not None:
                boxes = bridge.make_boxes(batch.given_objs, batch.given_cats, batch.mask)
            else:
                boxes = boxes_from_batch(batch, input_dims, contact, dev)
            gt_tr, gt_sz = translate_objs_to_bbox(batch.target_verts)
            loss = baseline_step(state, boxes, put(gt_tr), put(gt_sz),
                                 put(batch.target_cat))
            total += float(loss)
            n += 1
        mean = total / max(n, 1)
        logger.log("train/loss", mean, step=epoch)
        print(f"epoch {epoch}: loss {mean:.4f}")
        if mean < best:
            best = mean
            save_checkpoint(os.path.join(args.save_dir, f"best_model_{kind}.pt"),
                            state, extra={"epoch": epoch, "loss": mean, **meta})
    save_checkpoint(os.path.join(args.save_dir, f"final_{kind}.pt"), state,
                    extra={"epoch": args.epochs - 1, **meta})
    logger.close()
    return state


def eval_baseline(args, kind: str) -> Dict[str, float]:
    """Evaluate ``kind`` on ``args.data_dir``: ``results.txt`` and
    ``predictions/<seq>.npy`` under ``output_dir``.  Returns the five
    final metrics."""
    from lsdm_tpu_torch.checkpoint import load_atiss_checkpoint
    from lsdm_tpu_torch.data.dataset import DataLoader
    from lsdm_tpu_torch.ops.geometry import oriented_bbox, translate_bbox_obj
    from lsdm_tpu_torch.ops.metrics import emd, fscore, topk_accuracy
    from lsdm_tpu_torch.ops.pointcloud import chamfer_distance
    from lsdm_tpu_torch.weights import init_weights

    prog = f"test_{kind}"
    refuse_flax_checkpoints(args, prog)
    dev = jax_flags.device(args, prog)
    ckpt = read_checkpoint_file(args.load_model)
    resolve_parity_flags(args, ckpt)
    ds, num_cats = _datasets(args, args.data_dir)
    loader = DataLoader(ds, args.batch_size, shuffle=False)
    model, input_dims = build_model(kind, num_cats, args)
    init_weights(model, 0)
    if ckpt is not None:
        extra = load_atiss_checkpoint(ckpt, model)
        print(f"loaded {args.load_model}: "
              f"{ {k: v for k, v in extra.items() if k != FLAGS_KEY} }")
    model = model.to(dev).eval()
    contact = kind == "mime"
    bridge = _make_bridge(args, model, input_dims, dev) if kind == "cf_atiss" else None

    os.makedirs(os.path.join(args.output_dir, "predictions"), exist_ok=True)
    chs, emds, f1s, accs, top3s, lines = [], [], [], [], [], []
    for bi, batch in enumerate(loader):
        if bridge is not None:
            out = bridge(batch.given_objs, batch.given_cats, batch.mask)
        else:
            with torch.no_grad():
                out = model(boxes_from_batch(batch, input_dims, contact, dev))
        pred_sizes = torch.cat([out.sizes_x, out.sizes_y, out.sizes_z], -1)[:, 0].cpu().numpy()
        pred_tr = torch.cat([out.translations_x, out.translations_y,
                             out.translations_z], -1)[:, 0].cpu().numpy()
        logits = out.class_labels[:, 0].cpu()
        nvalid = len(set(batch.seq_names))
        for i, seq in enumerate(batch.seq_names[:nvalid]):
            pred_pts = translate_bbox_obj(pred_tr[i], np.abs(pred_sizes[i]) + 1e-3,
                                          1024, seed=bi * 64 + i)
            c, _, e = oriented_bbox(batch.target_verts[i])
            gt_pts = translate_bbox_obj(c, e, 1024, seed=bi * 64 + i + 7)
            p, g = torch.from_numpy(pred_pts)[None], torch.from_numpy(gt_pts)[None]
            chs.append(float(chamfer_distance(p, g)))
            emds.append(emd(p, g))
            f1s.append(float(fscore(p[0], g[0], 0.1)[0]))
            tcat = torch.from_numpy(batch.target_cat[i:i + 1]).argmax(dim=1)
            probs = logits[i:i + 1, :num_cats]
            (top1,) = topk_accuracy(probs, tcat, (1,))
            (top3,) = topk_accuracy(probs, tcat, (3,))
            accs.append(float(top1) / 100)
            top3s.append(float(top3) / 100)
            lines.append(f"Chamfer distance for seq {seq}: {chs[-1]:.4f}")
            np.save(os.path.join(args.output_dir, "predictions", seq + ".npy"), pred_pts)
    final = {"cfd": float(np.mean(chs)), "emd": float(np.mean(emds)),
             "f1": float(np.mean(f1s)), "acc": float(np.mean(accs)),
             "top3": float(np.mean(top3s))}
    with open(os.path.join(args.output_dir, "results.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
        f.write(f"Final Chamfer distance: {final['cfd']:.4f}\n")
        f.write(f"Final EMD: {final['emd']:.4f}\n")
        f.write(f"Final F1 score: {final['f1']:.4f}\n")
        f.write(f"Category accuracy: {final['acc']:.4f}\n")
        f.write(f"Top 3 accuracy: {final['top3']:.4f}\n")
    print(f"CFD {final['cfd']:.4f} | EMD {final['emd']:.4f} | F1 {final['f1']:.4f}"
          f" | acc {final['acc']:.4f} | top3 {final['top3']:.4f}")
    return final


def _make_bridge(args, atiss_model, input_dims: int, dev):
    """The ContactFormer -> ATISS bridge (reference
    ``run/test_cf_atiss.py:131-146``): a frozen POSA decoder over 655
    sampled human points, seeded (``--seed``) unless ``--cf_ckpt`` gives a
    trained one; ``atiss_model`` None where only the boxes are made."""
    from lsdm_tpu_torch.models.bridge import BridgeModel
    from lsdm_tpu_torch.models.posa import POSADecoder
    from lsdm_tpu_torch.ops.spiral import identity_spirals
    from lsdm_tpu_torch.weights import init_weights

    decoder = POSADecoder(np.tile(identity_spirals(655), (1, 9)), no_obj_classes=8)
    init_weights(decoder, args.seed)
    if args.cf_ckpt:
        print(f"loading ContactFormer POSA decoder from {args.cf_ckpt}")
        decoder.load_state_dict(posa_decoder_state_dict(args.cf_ckpt), strict=True)
    decoder = decoder.to(dev).eval()
    return BridgeModel(atiss_model, decoder, args.datatype, input_dims,
                       seed=args.seed, device=dev)


def posa_decoder_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The POSA decoder's weights of a ContactFormer (``posa.decoder.*``)
    or POSA (``decoder.*``) ``.pt``."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("model_state_dict", ckpt)
    for prefix in ("posa.decoder.", "decoder."):
        dec = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
        if dec:
            return dec
    raise SystemExit(f"--cf_ckpt {path}: no POSA decoder in it (keys posa.decoder.* "
                     "or decoder.*)")


def refuse_flax_checkpoints(args, prog: str) -> None:
    """Stop unless ``--load_model`` and ``--cf_ckpt`` are empty or torch
    ``.pt`` files."""
    for flag in ("load_model", "cf_ckpt"):
        path = getattr(args, flag, None)
        if path and not path.endswith(".pt"):
            raise SystemExit(f"--{flag} {path}: only torch .pt checkpoints load into "
                             f"the port (a flax .ckpt needs the JAX package's {prog})")


def read_checkpoint_file(path: Optional[str]) -> Optional[Dict[str, Any]]:
    if not path:
        return None
    return torch.load(path, map_location="cpu", weights_only=False)


def make_arg_parser(train: bool) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    if train:
        ap.add_argument("--train_data_dir", required=True)
        ap.add_argument("--epochs", type=int, default=100)
        ap.add_argument("--lr", type=float, default=1e-3)
        ap.add_argument("--save_dir", default="training_output")
    else:
        ap.add_argument("data_dir")
        ap.add_argument("--load_model", default=None,
                        help="a .pt of the port's trainer or of the reference")
        ap.add_argument("--output_dir", default="test_output")
    ap.add_argument("--cf_ckpt", default=None,
                    help="ContactFormer .pt (run/train_contactformer.py) whose POSA "
                         "decoder the cf_atiss bridge takes")
    ap.add_argument("--objs_data_dir", default=None)
    ap.add_argument("--datatype", default="proxd", choices=["proxd", "humanise"])
    ap.add_argument("--batch_size", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    jax_flags.add_device(ap)
    ap.add_argument("--feature_extractor", default=None,
                    choices=["simple", "resnet18", "alexnet"],
                    help="room-layout extractor; default: the checkpoint's own, "
                         "resnet18 for a reference .pt (networks/__init__.py:78), "
                         "else simple")
    ap.add_argument("--no_freeze_bn", action="store_true",
                    help="resnet18 BN live (eval-mode statistics) instead of frozen")
    ap.add_argument("--pe", action="store_true",
                    help="the learned-slot-positional-embedding variant (reference "
                         "network_type autoregressive_transformer_pe, repaired)")
    ap.add_argument("--torch_seq_axis_quirk", default=None,
                    action=argparse.BooleanOptionalAction,
                    help="the LSDM fork's batch-axis attention; default: the "
                         "checkpoint's own, on for a reference .pt, else off")
    return ap


def resolve_parity_flags(args, ckpt: Optional[Dict[str, Any]] = None) -> None:
    """Pick the graph a checkpoint needs, where the flags leave it open.  A
    port checkpoint names its own (``atiss_flags``); a reference ``.pt``
    gives wrong numbers unless the graph has the torchvision ResNet18 and
    the LSDM fork's batch-axis attention, so both default on for one, as
    the JAX CLIs default them for a ``.pt``; with no checkpoint, the simple
    extractor and token-axis attention.  Explicit flags win."""
    own = (ckpt or {}).get(FLAGS_KEY)
    reference = ckpt is not None and own is None
    if args.feature_extractor is None:
        args.feature_extractor = (own["feature_extractor"] if own
                                  else "resnet18" if reference else "simple")
        if reference:
            print("auto: --feature_extractor resnet18 (reference checkpoint)")
    if args.torch_seq_axis_quirk is None:
        args.torch_seq_axis_quirk = own["torch_seq_axis_quirk"] if own else reference
        if reference:
            print("auto: --torch_seq_axis_quirk (reference checkpoint)")
    if own:
        args.no_freeze_bn = args.no_freeze_bn or not own["freeze_bn"]
        if hasattr(args, "pe"):
            args.pe = args.pe or own["pe"]
