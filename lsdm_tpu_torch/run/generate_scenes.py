"""Generate whole scenes autoregressively with a trained ATISS / MIME model.

Counterpart of ``lsdm_tpu/run/generate_scenes.py``: ``generate_boxes`` (or
``complete_scene`` from ``--complete_from``'s partial boxes) of
``models/atiss.py`` as a CLI, the capability of the reference's
``AutoregressiveTransformer.generate_boxes``
(``autoregressive_transformer.py:209-227``).  Writes one
``scene_XXXX.npz`` a scene with ``class_labels (K, C)``, ``translations (K,
3)``, ``sizes (K, 3)``, ``angles (K, 1)``, ``valid_mask (K,)`` and
``count`` (boxes generated, the end symbol included).

``--load_model`` takes a ``.pt`` of the port's trainer or of the
reference; the graph flags default to the checkpoint's own (resnet18 and
the batch-axis quirk for a reference one, ``run/_baseline_common.py:
resolve_parity_flags``).  The draws come from one ``torch.Generator`` on
``--device`` (cuda unless ``cpu`` is asked for), seeded with ``--seed``.

    python -m lsdm_tpu_torch.run.generate_scenes --load_model M.pt \\
        [--n_scenes 4] [--max_boxes 12] [--output_dir generated_scenes]
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional, Sequence

from lsdm_tpu_torch.run import jax_flags


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--load_model", required=True,
                    help=".pt of the port's trainer or of the reference")
    ap.add_argument("--kind", default="atiss", choices=["atiss", "atiss_pe", "mime"])
    ap.add_argument("--datatype", default="proxd", choices=["proxd", "humanise"])
    ap.add_argument("--n_scenes", type=int, default=4)
    ap.add_argument("--max_boxes", type=int, default=12)
    ap.add_argument("--room_mask", default=None,
                    help=".npy layout mask (1, 1, 64, 64) or (64, 64); default "
                         "all ones, as the LSDM training path (run/train_atiss.py:68)")
    ap.add_argument("--complete_from", default=None,
                    help=".npz of partial boxes to complete (complete_scene "
                         "instead of generate_boxes)")
    ap.add_argument("--output_dir", default="generated_scenes")
    ap.add_argument("--seed", type=int, default=0)
    jax_flags.add_device(ap)
    ap.add_argument("--feature_extractor", default=None,
                    choices=["simple", "resnet18", "alexnet"])
    ap.add_argument("--no_freeze_bn", action="store_true")
    ap.add_argument("--torch_seq_axis_quirk", default=None,
                    action=argparse.BooleanOptionalAction)
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> List[str]:
    """Generate; returns the files written."""
    args = parse_args(argv)
    import numpy as np
    import torch

    from lsdm_tpu_torch import config as cfg_lib
    from lsdm_tpu_torch.checkpoint import load_atiss_checkpoint
    from lsdm_tpu_torch.models import atiss as A
    from lsdm_tpu_torch.run._baseline_common import (
        build_model, read_checkpoint_file, refuse_flax_checkpoints,
        resolve_parity_flags)

    refuse_flax_checkpoints(args, "generate_scenes")
    dev = jax_flags.device(args, "generate_scenes")
    ckpt = read_checkpoint_file(args.load_model)
    resolve_parity_flags(args, ckpt)
    model, _ = build_model(args.kind, cfg_lib.num_cats_for(args.datatype), args)
    load_atiss_checkpoint(ckpt, model)
    model = model.to(dev).eval()

    if args.room_mask:
        room = torch.as_tensor(np.load(args.room_mask), dtype=torch.float32)
        if room.dim() == 2:
            room = room[None, None]
    else:
        room = torch.ones(1, 1, 64, 64)
    room = room.to(dev)
    partial = None
    if args.complete_from:
        with np.load(args.complete_from) as d:
            partial = {k: torch.as_tensor(d[k], dtype=torch.float32, device=dev)[None]
                       for k in ("class_labels", "translations", "sizes", "angles")}

    os.makedirs(args.output_dir, exist_ok=True)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    written = []
    for i in range(args.n_scenes):
        if partial is not None:
            boxes, count = A.complete_scene(model, partial, room, gen,
                                            max_boxes=args.max_boxes)
        else:
            boxes, count = A.generate_boxes(model, room, gen, max_boxes=args.max_boxes)
        out = os.path.join(args.output_dir, f"scene_{i:04d}.npz")
        np.savez(out, count=count, **{
            k: boxes[k][0].cpu().numpy()
            for k in ("class_labels", "translations", "sizes", "angles", "valid_mask")})
        print(f"{out}: {count} boxes")
        written.append(out)
    return written


if __name__ == "__main__":
    main()
