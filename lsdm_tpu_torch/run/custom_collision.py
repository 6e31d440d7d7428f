"""Collision/consistency score between generated objects and the given
scene (reference ``custom_collision.py:82-131``).

Counterpart of ``lsdm_tpu/run/custom_collision.py``, with its arguments:
for each sequence, the recall-style F-score component between the
prediction cloud and ALL given objects' points — high overlap means the
generated object collides with existing scene geometry.  The distances
are taken on ``--device`` (cuda by default; without a GPU it refuses
unless ``--device cpu`` is given; the JAX flag ``--platform`` is refused).
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

from lsdm_tpu_torch.run import jax_flags


def main(argv: Optional[Sequence[str]] = None) -> float:
    """Print and return the mean collision score."""
    ap = argparse.ArgumentParser()
    ap.add_argument("data_dir")
    ap.add_argument("--predictions_dir", required=True)
    ap.add_argument("--objs_data_dir", default=None)
    ap.add_argument("--datatype", default="proxd", choices=["proxd", "humanise"])
    ap.add_argument("--threshold", type=float, default=0.1)
    jax_flags.add_device(ap)
    args = ap.parse_args(argv)
    dev = jax_flags.device(args, "custom_collision")

    import numpy as np
    import torch

    from lsdm_tpu_torch.data.dataset import DataLoader, Humanise, ProxDatasetTxt
    from lsdm_tpu_torch.ops.metrics import fscore

    num_cats = 13 if args.datatype == "proxd" else 11  # JAX config.num_cats_for
    ds_cls = ProxDatasetTxt if args.datatype == "proxd" else Humanise
    kw = {"objs_data_dir": args.objs_data_dir} if args.objs_data_dir else {}
    ds = ds_cls(args.data_dir, max_cats=num_cats, **kw)
    loader = DataLoader(ds, 1, shuffle=False)

    scores = []
    for batch in loader:
        seq = batch.seq_names[0]
        pred_path = os.path.join(args.predictions_dir, seq + ".npy")
        if not os.path.exists(pred_path):
            continue
        pred = np.load(pred_path).astype(np.float32).reshape(-1, 3)
        given = np.asarray(batch.given_objs[0]).reshape(-1, 3)
        # recall component of the F-score (reference uses f1_score[2])
        _, _, recall = fscore(torch.as_tensor(pred, device=dev),
                              torch.as_tensor(given, device=dev), args.threshold)
        scores.append(float(recall))
    score = float(np.mean(scores))
    print(f"collision score over {len(scores)} sequences: {score:.4f}")
    return score


if __name__ == "__main__":
    main()
