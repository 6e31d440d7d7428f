"""Flags of the JAX package's CLIs that the port's CLIs take only to refuse:
the run stops with the reason instead of argparse's "unrecognized
arguments".  Also ``--device``, which takes ``--platform``'s place."""

from __future__ import annotations

import argparse

REASONS = {
    "platform": "it picks a JAX platform; the port takes --device (cuda or "
                "cpu)",
}


def add(ap: argparse.ArgumentParser, *names: str) -> None:
    """Add the JAX flags ``names`` (keys of ``REASONS``), default None."""
    for name in names:
        ap.add_argument(f"--{name}", default=None,
                        help=f"JAX CLI flag, refused: {REASONS[name]}")


def refuse(args: argparse.Namespace, *names: str) -> None:
    """Stop with the reason if one of the JAX flags ``names`` was given."""
    for name in names:
        if getattr(args, name) is not None:
            raise SystemExit(f"--{name} is not ported: {REASONS[name]}")


def add_device(ap: argparse.ArgumentParser) -> None:
    """``--platform`` (refused) and ``--device`` (cuda by default)."""
    add(ap, "platform")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' must be asked for explicitly")


def device(args: argparse.Namespace, prog: str):
    """``--device`` as a torch device; ``--platform`` refused, and no silent
    CPU run where CUDA was asked for and is missing."""
    import torch

    refuse(args, "platform")
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"{prog}: no CUDA device; pass --device cpu to run on "
                         "the CPU")
    return dev
