"""Model and diffusion factory, the API of reference
``util/model_util.py:16-23`` (``create_model_and_diffusion(datatype)``).

Counterpart of ``lsdm_tpu/factory.py``: the ``SceneDiffusionModel`` of the
dataset's preset and the diffusion ``Schedule`` of the canonical
hyper-parameters (1000 steps, cosine, predict x_start, FIXED_SMALL,
lambda_cat 0.1), respaced when the configuration asks for it.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from lsdm_tpu_torch import config as cfg_lib
from lsdm_tpu_torch.config import DiffusionConfig
from lsdm_tpu_torch.diffusion.schedule import Schedule, make_schedule, spaced_schedule
from lsdm_tpu_torch.models.sdm import SceneDiffusionModel


def create_model_and_diffusion(datatype: str = "proxd",
                               diffusion_cfg: DiffusionConfig = DiffusionConfig(),
                               device=None, **model_overrides
                               ) -> Tuple[SceneDiffusionModel, Schedule]:
    """(model, schedule): the model of the ``"proxd"`` or ``"humanise"``
    preset with ``model_overrides`` applied (its parameters at torch's
    defaults: load a checkpoint or call ``weights.init_weights``), and the
    schedule of ``diffusion_cfg`` on ``device``."""
    model_cfg = cfg_lib.sdm_proxd() if datatype == "proxd" else cfg_lib.sdm_humanise()
    if model_overrides:
        model_cfg = dataclasses.replace(model_cfg, **model_overrides)
    if diffusion_cfg.timestep_respacing:
        schedule = spaced_schedule(diffusion_cfg.noise_schedule, diffusion_cfg.steps,
                                   diffusion_cfg.timestep_respacing, device=device)
    else:
        schedule = make_schedule(diffusion_cfg.noise_schedule, diffusion_cfg.steps,
                                 device=device)
    return SceneDiffusionModel(model_cfg), schedule


def load_yaml_config(path: str) -> dict:
    """YAML config loader of the ATISS family (reference
    ``atiss/scripts/training_utils.py:22-25``)."""
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)
