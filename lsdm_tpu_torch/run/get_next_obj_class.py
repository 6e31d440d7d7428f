"""Draw the next object's class and a translation inside a box (reference
``get_next_obj_class.py``): ATISS's class distribution and DMLL
translations redrawn until inside (``fitting/next_obj_class.py``).

Counterpart of ``lsdm_tpu/run/get_next_obj_class.py``; prints one JSON
line ``{"class": c, "translation": [x, y, z]}``.  ``--load_model`` takes
an ATISS ``.pt`` with DMLL heads (``scalar_head=False``); without one the
weights are seeded with ``--seed``.  The draws come from a
``torch.Generator`` on ``--device`` (cuda unless ``cpu`` is asked for),
seeded with ``--seed``.

    python -m lsdm_tpu_torch.run.get_next_obj_class [--load_model M.pt] \\
        [--bbox_min -1 -1 -1] [--bbox_max 1 1 1] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

from lsdm_tpu_torch.run import jax_flags


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--load_model", default=None, help="ATISS .pt (DMLL heads)")
    ap.add_argument("--num_classes", type=int, default=23)
    ap.add_argument("--bbox_min", type=float, nargs=3, default=[-1, -1, -1])
    ap.add_argument("--bbox_max", type=float, nargs=3, default=[1, 1, 1])
    ap.add_argument("--seed", type=int, default=0)
    jax_flags.add_device(ap)
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    import numpy as np
    import torch

    from lsdm_tpu_torch.checkpoint import load_atiss_checkpoint
    from lsdm_tpu_torch.fitting.next_obj_class import sample_in_bbox
    from lsdm_tpu_torch.models.atiss import AutoregressiveTransformer
    from lsdm_tpu_torch.run._baseline_common import (
        graph_kwargs, read_checkpoint_file, refuse_flax_checkpoints,
        resolve_parity_flags)
    from lsdm_tpu_torch.weights import init_weights

    refuse_flax_checkpoints(args, "get_next_obj_class")
    dev = jax_flags.device(args, "get_next_obj_class")
    ckpt = read_checkpoint_file(args.load_model)
    graph = argparse.Namespace(feature_extractor=None, torch_seq_axis_quirk=None,
                               no_freeze_bn=False)
    resolve_parity_flags(graph, ckpt)
    C = args.num_classes
    model = init_weights(AutoregressiveTransformer(C, scalar_head=False,
                                                   **graph_kwargs(graph)), args.seed)
    if ckpt is not None:
        load_atiss_checkpoint(ckpt, model)
    model = model.to(dev).eval()
    boxes = {k: torch.zeros(1, 1, w, device=dev) for k, w in (
        ("class_labels", C), ("translations", 3), ("sizes", 3), ("angles", 1),
        ("class_labels_tr", C), ("translations_tr", 3), ("sizes_tr", 3),
        ("angles_tr", 1))}
    boxes["room_layout"] = torch.ones(1, 1, 64, 64, device=dev)
    cls, tr = sample_in_bbox(model, boxes, np.asarray(args.bbox_min),
                             np.asarray(args.bbox_max),
                             torch.Generator(device=dev).manual_seed(args.seed))
    out = {"class": int(cls), "translation": [float(x) for x in tr]}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
