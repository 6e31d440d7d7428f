"""Sinusoidal positional-encoding table."""

from __future__ import annotations

import numpy as np


def positional_encoding_table(d_model: int, max_len: int = 5000) -> np.ndarray:
    """Interleaved sin/cos PE table, shape (max_len, d_model), float32.

    Copied from ``lsdm_tpu/ops/embeddings.py:positional_encoding_table``
    (reference ``model/diffusion_utils.py:24-37``: pe[:, 0::2] = sin,
    pe[:, 1::2] = cos); the SDM's timestep embedder indexes it by the
    integer timestep.
    """
    pe = np.zeros((max_len, d_model), dtype=np.float32)
    position = np.arange(0, max_len, dtype=np.float32)[:, None]
    div_term = np.exp(
        np.arange(0, d_model, 2, dtype=np.float32) * (-np.log(10000.0) / d_model)
    )
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe
