"""What the fitting CLIs share: the device flag and the human surface."""

from __future__ import annotations

import argparse

import numpy as np
import torch

from lsdm_tpu_torch.run import jax_flags


def add_device(ap: argparse.ArgumentParser) -> None:
    """``--platform`` (refused) and ``--device`` (cuda by default)."""
    jax_flags.add(ap, "platform")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the pose search and refinement; "
                         "'cpu' must be asked for explicitly")


def device(args: argparse.Namespace, prog: str) -> torch.device:
    """The device the CLI computes on; no silent CPU run."""
    jax_flags.refuse(args, "platform")
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"{prog}: no CUDA device; pass --device cpu to run on "
                         "the CPU")
    return dev


def human_surface(verts_seq: np.ndarray, faces) -> np.ndarray:
    """Points of the human sequence's surface: 4096 samples a frame when
    faces are given, else the vertices (JAX ``run/fit_*_obj.py``)."""
    from lsdm_tpu_torch.fitting.meshio import sample_surface

    if faces is None:
        return verts_seq.reshape(-1, 3)
    return np.concatenate([sample_surface(v, faces, 4096, seed=i)
                           for i, v in enumerate(verts_seq)])
