"""cuDNN in full float32.

cuDNN runs convolutions and LSTMs in TF32 unless told otherwise
(``torch.backends.cudnn.allow_tf32`` defaults to True), and it reads the
setting again when it builds a backward.  The JAX package's products are
float32, so the port's cuDNN layers (ContactFormer's LSTM, the ATISS
room-layout extractors) run their forward, and their trainers the
backward, under :func:`cudnn_full_fp32`.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch


@contextlib.contextmanager
def cudnn_full_fp32() -> Iterator[None]:
    """TF32 off for cuDNN over the block: float32 products, as JAX's."""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved
