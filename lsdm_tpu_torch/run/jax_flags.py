"""Flags of the JAX package's CLIs that the port's CLIs take only to refuse:
the run stops with the reason instead of argparse's "unrecognized
arguments"."""

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
