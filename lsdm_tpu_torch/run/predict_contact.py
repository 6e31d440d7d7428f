"""Sample SDM predictions for a whole split -> ``predictions/<seq>.npy``.

Counterpart of ``lsdm_tpu/run/predict_contact.py`` (reference
``run/predict_contact.py``, which ships with a syntax error at ``:75``;
the JAX package's is the working equivalent), with its flags: the
sampling loop of ``test_sdm`` without the metrics.  It builds the model,
the loader and the text encoder with ``run/test_sdm.py:setup_sampling``
and samples with ``sample_batch``, so on CUDA it takes the fused path
(K3, K7, K8 and K4 in the encode, K6 for the T steps).

    python -m lsdm_tpu_torch.run.predict_contact DATA_DIR \\
        --objs_data_dir OBJS [--load_model model.pt] [--device cuda]

``--device`` defaults to ``cuda``; without a GPU the CLI raises unless
``--device cpu`` is given.  Without ``--load_model`` the weights are
seeded (seed 0); the draws come from one ``torch.Generator`` on the
device, seeded with ``--seed``.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional, Sequence

from lsdm_tpu_torch.run import jax_flags


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("data_dir")
    ap.add_argument("--load_model", default=None,
                    help="a reference torch .pt checkpoint")
    ap.add_argument("--objs_data_dir", default=None)
    ap.add_argument("--output_dir", default="predict_output")
    ap.add_argument("--datatype", default="proxd", choices=["proxd", "humanise"])
    ap.add_argument("--batch_size", type=int, default=4)
    ap.add_argument("--diffusion_steps", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--text_encoder", default="auto",
                    choices=["auto", "CLIP", "BERT", "HASH"],
                    help="'auto' = CLIP when a BPE merges source exists, else "
                         "HASH")
    jax_flags.add_device(ap)
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> List[str]:
    """Sample every sequence; returns the paths written."""
    args = parse_args(argv)

    import numpy as np
    import torch

    from lsdm_tpu_torch.run.test_sdm import (refuse_flax_checkpoint,
                                             sample_batch, setup_sampling)

    refuse_flax_checkpoint(args, "predict_contact")
    dev = jax_flags.device(args, "predict_contact")
    out_dir = os.path.join(args.output_dir, "predictions")
    os.makedirs(out_dir, exist_ok=True)
    s = setup_sampling(args, dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    written = []
    for bi, batch in enumerate(s.loader):
        pred, _ = sample_batch(s, batch, gen)
        nvalid = len(set(batch.seq_names))  # the padded tail repeats the last seq
        for i, seq in enumerate(batch.seq_names[:nvalid]):
            path = os.path.join(out_dir, seq + ".npy")
            np.save(path, pred[i].cpu().numpy().astype(np.float32))
            written.append(path)
        print(f"batch {bi}: wrote {nvalid} predictions")
    return written


if __name__ == "__main__":
    main()
