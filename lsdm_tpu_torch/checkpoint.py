"""Loading a reference ``.pt`` checkpoint into the port's model.

Counterpart of ``lsdm_tpu/train/checkpoint.py:load_torch_checkpoint``.  The
port's ``state_dict`` keys already are the reference torch model's, so
there is nothing to convert: the ``model_state_dict`` is unwrapped, the
frozen text tower's keys (``clip_model.*``, ``text_encoder_model.*``),
which the JAX converter skips too, are dropped, and the rest loads with
``strict=True``.  The JAX function's ``max_cats`` argument is not needed:
its converter never reads it, and here a checkpoint whose category head
has another width than the model's fails the strict load.  Training
checkpoints (``train/checkpoint.py``) load here too; their optimizer
state, step and EMA are left out of the metadata returned.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

_SKIPPED = ("clip_model.", "text_encoder_model.")

# the training state train/checkpoint.py writes beside the model
TRAIN_STATE_KEYS = ("model_state_dict", "optimizer_state_dict", "step",
                    "ema_state_dict")


def read_checkpoint(path: str, model: nn.Module) -> Dict[str, Any]:
    """Load the model weights of the checkpoint at ``path`` into ``model``
    (in place) and return the whole checkpoint."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("model_state_dict", ckpt)
    model.load_state_dict({k: v for k, v in sd.items()
                           if not k.startswith(_SKIPPED)}, strict=True)
    return ckpt


def load_torch_checkpoint(path: str, model: nn.Module) -> Dict[str, Any]:
    """Load the checkpoint at ``path`` into ``model`` (in place) and
    return its other top-level entries (epoch, losses, ...)."""
    return {k: v for k, v in read_checkpoint(path, model).items()
            if not hasattr(v, "detach") and k not in TRAIN_STATE_KEYS}
