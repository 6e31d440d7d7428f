"""Training checkpoints of the port: the reference's own ``.pt`` format.

Counterpart of ``lsdm_tpu/train/checkpoint.py`` (``save``, ``load``).
:func:`save_checkpoint` writes ``torch.save({"epoch", "model_state_dict",
"optimizer_state_dict", ...})`` as the reference trainer does
(``run/train_sdm.py:294-337``), with the train step count and the count
of updates applied (``updates``, which the learning-rate anneal reads), the EMA
parameters when there are any, and a JSON sidecar of the metadata like
the JAX package's ``save``.  The JAX package's ``load_torch_checkpoint``
reads such a file, and so does the port's model loader
(``lsdm_tpu_torch/checkpoint.py``); :func:`load_checkpoint` resumes the
whole training state from it.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional

import torch

from lsdm_tpu_torch.checkpoint import TRAIN_STATE_KEYS, read_checkpoint
from lsdm_tpu_torch.train.state import TrainState


def save_checkpoint(path: str, state: TrainState,
                    extra: Optional[Dict[str, Any]] = None) -> None:
    """Write ``state`` as a reference ``.pt`` checkpoint at ``path`` and
    ``extra`` (JSON-able metadata: epoch, losses) beside it as
    ``path + ".json"``."""
    extra = dict(extra or {})
    ckpt = {**extra, "model_state_dict": state.model.state_dict(),
            "optimizer_state_dict": state.optimizer.state_dict(),
            "step": state.step, "updates": state.updates}
    if state.ema_params is not None:
        ckpt["ema_state_dict"] = state.ema_params
    torch.save(ckpt, path)
    with open(path + ".json", "w") as f:
        json.dump(extra, f)


def load_checkpoint(path: str, state: TrainState) -> Dict[str, Any]:
    """Resume ``state`` (model, optimizer, step, EMA) from a checkpoint that
    :func:`save_checkpoint` wrote; returns its metadata."""
    ckpt = read_checkpoint(path, state.model)
    state.optimizer.load_state_dict(ckpt["optimizer_state_dict"])
    state.step = int(ckpt["step"])
    state.updates = int(ckpt.get("updates", state.step))
    if state.ema_params is not None and "ema_state_dict" in ckpt:
        for k, v in ckpt["ema_state_dict"].items():
            state.ema_params[k].copy_(v)
    return {k: v for k, v in ckpt.items() if k not in TRAIN_STATE_KEYS}
