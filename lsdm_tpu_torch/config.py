"""SceneDiffusionModel configuration of the port.

The fields the port reads from the JAX package's ``SDMConfig``
(``lsdm_tpu/config.py``), with the same names and defaults, its
``sdm_proxd`` / ``sdm_humanise`` presets (reference
``util/model_util.py:26-73``) and its dataset category tables.  A copy, so
that the port imports nothing of the JAX package;
``tests/test_torch_weights.py`` holds it to the original.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SDMConfig:
    """SceneDiffusionModel hyper-parameters (reference ``model/sdm.py:
    19-22`` overridden by ``util/model_util.py:26-73``)."""

    clip_dim: int = 512
    n_head: int = 8
    cat_emb: int = 32
    latent_dim: int = 128
    vert_dims: int = 655
    pcd_points: int = 1024
    pcd_dim: int = 3
    xyz_dim: int = 3
    max_cats: int = 13
    translation_params: int = 12
    max_objs: int = 9  # 8 scene objects + slot 0 = human
    pcd_backbone_type: str = "PNT2"  # "PNT2" | "DGCNN"
    human_backbone_type: str = "POSA"  # "POSA" | "P2R" (the STGCN)
    # "auto" skips FPS where it would select every point (sa1 at N=1024);
    # "exact" always runs it
    fps_mode: str = "auto"
    # compute dtype of the denoiser and both backbones: "float32" or
    # "bfloat16" (flax's casts: parameters stay float32, every Dense casts
    # its input, weight and bias; models/common.py:compute_dtype)
    dtype: str = "float32"
    # the PointNet++ BatchNorms' output dtype; their statistics and
    # normalisation stay float32 (flax's promotion)
    bn_dtype: str = "float32"
    # "auto" / "pallas": the hand-written selection kernels for CUDA
    # tensors, their plain versions for CPU tensors; "topk": the plain
    # versions on any device; "fused": the fused eval stage kernels K7/K8
    # and the rank-1 attention K4 (models/pointnet2.py).  Entry points
    # resolve "auto" to "fused" on CUDA (models/sampling.py); "sg": the
    # train select-gather kernel K10 in the SA stages
    ball_impl: str = "auto"
    # train-time pcd_attention: "xla" the composed formulation, "pallas"
    # the rank-1 kernels K4/K5 (the train entry point resolves "auto")
    attn_impl: str = "xla"


@dataclasses.dataclass(frozen=True)
class DiffusionConfig:
    """The diffusion settings training reads (JAX ``DiffusionConfig``,
    reference ``util/model_util.py:127-163``)."""

    steps: int = 1000
    noise_schedule: str = "cosine"
    timestep_respacing: str = ""  # "" -> every step; "ddimN" / "N" respace
    lambda_cat: float = 0.1


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The training-loop settings the port reads (JAX ``TrainConfig``,
    reference ``run/train_sdm.py:186-337``)."""

    lr: float = 1e-3
    # torch AdamW's default, which the reference silently uses
    weight_decay: float = 0.01
    epochs: int = 1000
    eval_every: int = 50  # validate + checkpoint cadence
    ema_rate: float = 0.0  # parameter EMA (0 = off)
    lr_anneal_steps: int = 0  # linear LR anneal horizon (0 = constant)


def sdm_proxd() -> SDMConfig:
    """PRO-teXt preset (reference ``get_default_model_proxd``)."""
    return SDMConfig(max_cats=13)


def sdm_humanise() -> SDMConfig:
    """HUMANISE preset (reference ``get_default_model_humanise``)."""
    return SDMConfig(max_cats=11)


# Category tables (reference ``posa/dataset.py:404-422`` / ``:533-548``).
PROXD_CATEGORIES = {
    "chair": 1,
    "table": 2,
    "cabinet": 3,
    "sofa": 4,
    "bed": 5,
    "chest_of_drawers": 6,
    "chest": 6,
    "stool": 7,
    "tv_monitor": 8,
    "tv": 8,
    "lighting": 9,
    "shelving": 10,
    "seating": 11,
    "furniture": 12,
    "human": 0,
}

HUMANISE_CATEGORIES = {
    "bed": 1,
    "sofa": 2,
    "table": 3,
    "door": 4,
    "desk": 5,
    "refrigerator": 6,
    "chair": 7,
    "counter": 8,
    "bookshelf": 9,
    "cabinet": 10,
    "human": 0,
}


def categories_for(datatype: str) -> dict:
    return PROXD_CATEGORIES if datatype == "proxd" else HUMANISE_CATEGORIES


def num_cats_for(datatype: str) -> int:
    return 13 if datatype == "proxd" else 11
