"""Contact-reconstruction metrics (reference ``posa/general_utils.py``).

Counterpart of ``lsdm_tpu/ops/recon_metrics.py``, for the POSA /
ContactFormer lineage: masked cross-entropy and accuracy over contact
classes, IoU / F1 / TPR / TNR on binarised contact, and the
neighbourhood-consistency metric.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from lsdm_tpu_torch.ops.pointcloud import square_distance


def compute_recon_loss(
    gt_batch: torch.Tensor,  # (B, V) int class labels (or (B, V, C) one-hot)
    pr_batch: torch.Tensor,  # (B, V, C) logits
    mask: Optional[torch.Tensor] = None,  # (B, V)
    reduction: str = "mean",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked CE + argmax accuracy over contact classes (reference
    ``general_utils.py:7-29``)."""
    gt = gt_batch.argmax(-1) if gt_batch.dim() == pr_batch.dim() else gt_batch.long()
    logp = F.log_softmax(pr_batch, dim=-1)
    nll = -torch.gather(logp, -1, gt[..., None])[..., 0]  # (B, V)
    correct = (pr_batch.argmax(-1) == gt).float()
    if mask is not None:
        m = mask.float()
        denom = torch.clamp(m.sum(), min=1.0)
        return (nll * m).sum() / denom, (correct * m).sum() / denom
    loss = nll.mean() if reduction == "mean" else nll.sum()
    return loss, correct.mean()


def _binarize(x: torch.Tensor) -> torch.Tensor:
    """Contact = class > 0 (class 0 is 'no contact')."""
    return (x > 0).float()


def compute_iou(gt: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """IoU of binarised contact (reference ``general_utils.py:67-74``); 1
    where both are empty."""
    g, p = _binarize(gt), _binarize(pred)
    inter = torch.sum(g * p)
    union = torch.sum(torch.clamp(g + p, 0, 1))
    return torch.where(union > 0, inter / torch.clamp(union, min=1.0),
                       torch.ones_like(union))


def compute_f1_score(gt: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """(reference ``general_utils.py:76-94``)"""
    g, p = _binarize(gt), _binarize(pred)
    tp = torch.sum(g * p)
    fp = torch.sum((1 - g) * p)
    fn = torch.sum(g * (1 - p))
    precision = tp / torch.clamp(tp + fp, min=1.0)
    recall = tp / torch.clamp(tp + fn, min=1.0)
    total = precision + recall
    return torch.where(total > 0, 2 * precision * recall / torch.where(
        total > 0, total, torch.ones_like(total)), torch.zeros_like(total))


def compute_tpr(gt: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    g, p = _binarize(gt), _binarize(pred)
    tp = torch.sum(g * p)
    fn = torch.sum(g * (1 - p))
    return tp / torch.clamp(tp + fn, min=1.0)


def compute_tnr(gt: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    g, p = _binarize(gt), _binarize(pred)
    tn = torch.sum((1 - g) * (1 - p))
    fp = torch.sum((1 - g) * p)
    return tn / torch.clamp(tn + fp, min=1.0)


def compute_consistency_metric(
    verts: torch.Tensor,   # (V, 3)
    labels: torch.Tensor,  # (V,) int contact classes
    eps: float = 0.1,
    num_classes: int = 8,
) -> torch.Tensor:
    """Fraction of contact points whose label disagrees with the mode of
    their eps-neighbourhood, self included (reference
    ``general_utils.py:121-146``); the mode's ties go to the lowest class."""
    d2 = square_distance(verts[None], verts[None])[0]  # (V, V)
    nbr = (d2 <= eps ** 2).float()
    counts = nbr @ F.one_hot(labels.long(), num_classes).float()  # (V, C)
    mode = counts.argmax(-1)
    contact = labels > 0
    disagree = (mode != labels) & contact
    return disagree.sum() / torch.clamp(contact.sum(), min=1)
