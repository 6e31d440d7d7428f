"""Seed fixing (reference ``util/fixseed.py``): Python, numpy and torch.

Counterpart of ``lsdm_tpu/utils/fixseed.py``, which seeds the host RNGs
and returns the root JAX key that the JAX package threads through its
programs; the port threads seeded ``torch.Generator``s instead, and this
returns one.
"""

from __future__ import annotations

import random
from typing import Optional

import numpy as np
import torch


def fixseed(seed: int, device: Optional[torch.device] = None) -> torch.Generator:
    """Seed ``random``, numpy's global generator and torch's default
    generators (every card's too), and return a ``torch.Generator`` on
    ``device`` (default the CPU) seeded with ``seed``."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator(device=device or "cpu").manual_seed(seed)
