"""The ContactFormer train step.

The JAX package writes it inside ``lsdm_tpu/run/train_contactformer.py:
80-97``: the masked per-vertex contact cross-entropy
(``ops/recon_metrics.py:compute_recon_loss``) plus ``kl_beta`` times the
VAE's KL, one ``optax.adam(lr)`` update.  Here the update is
``torch.optim.Adam(lr)``, whose defaults (0.9, 0.999, eps 1e-8) are
optax's.  No dropout runs: the JAX model has none on this path.  The
backward runs under ``cudnn_full_fp32``, so decoder mode 4's cuDNN LSTM
keeps float32 products there too.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from lsdm_tpu_torch.models.cudnn import cudnn_full_fp32
from lsdm_tpu_torch.ops.recon_metrics import compute_recon_loss


def contact_loss(model: nn.Module, cf: torch.Tensor, verts: torch.Tensor,
                 mask: torch.Tensor, kl_beta: float,
                 eps: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None
                 ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """(loss, (recon, acc, kl)) of one window: ``cf`` (T, V, C) one-hots,
    ``verts`` (T, V, 3), ``mask`` (1, T)."""
    out, mu, logvar = model(cf, verts, mask, eps, generator)
    gt = cf.argmax(-1)[None]  # (1, T, V)
    frame_mask = mask[..., None].expand(gt.shape)  # (1, T, V)
    recon, acc = compute_recon_loss(gt, out, mask=frame_mask)
    kl = -0.5 * torch.mean(1 + logvar - mu ** 2 - torch.exp(logvar))
    return recon + kl_beta * kl, (recon, acc, kl)


def contact_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                       cf: torch.Tensor, verts: torch.Tensor, mask: torch.Tensor,
                       kl_beta: float, eps: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One update; returns (loss, recon, acc), detached."""
    optimizer.zero_grad(set_to_none=True)
    loss, (recon, acc, _) = contact_loss(model, cf, verts, mask, kl_beta, eps,
                                         generator)
    with cudnn_full_fp32():
        loss.backward()
    optimizer.step()
    return loss.detach(), recon.detach(), acc.detach()
