"""lsdm_tpu_torch — SDM sampling, training and their entry points in
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

A second package beside the JAX one (``lsdm_tpu``), which stays the
reference: public functions keep its layouts and names (channel-last
``(B, S, K, C)`` groups, ``(B, N, 3)`` clouds, ``CondCache`` and
``DenoiserOutput`` fields) and parameter names follow the reference torch
``state_dict`` keys, so each counterpart is found by path and compared
like with like.

The package imports ``torch``, ``numpy`` and ``scipy`` (the exact EMD),
never ``jax`` and nothing of ``lsdm_tpu`` (its configuration is a copy,
:mod:`lsdm_tpu_torch.config`).
Importing it builds nothing: the CUDA kernels under ``csrc/`` are
compiled with ``nvcc`` at their first launch (:mod:`lsdm_tpu_torch.kernels`).
On a CPU tensor every kernel wrapper runs its plain PyTorch version
instead.
"""

from lsdm_tpu_torch.config import SDMConfig, sdm_humanise, sdm_proxd

__all__ = ["SDMConfig", "sdm_humanise", "sdm_proxd"]
