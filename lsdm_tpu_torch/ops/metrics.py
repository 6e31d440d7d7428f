"""Evaluation metrics: exact EMD, its Sinkhorn approximation, F-score,
top-k accuracy.

Counterpart of ``lsdm_tpu/ops/metrics.py`` (reference
``util/evaluation.py``): the Hungarian EMD on the host through scipy, and
the Sinkhorn EMD (an in-training monitor), the F-score and top-k accuracy
in torch.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from lsdm_tpu_torch.ops.pointcloud import square_distance


def emd(pred: torch.Tensor, gt: torch.Tensor) -> float:
    """Exact EMD per batch element, averaged: pred, gt (B, N, 3).  The
    assignment is scipy's Hungarian ``linear_sum_assignment`` on euclidean
    (not squared) distances, cost ``d[rows, cols].sum() / min(N, M)``
    (reference ``util/evaluation.py:5-11``)."""
    from scipy.optimize import linear_sum_assignment

    d = torch.sqrt(torch.clamp(square_distance(pred.float(), gt.float()),
                               min=0.0)).cpu().numpy()
    costs = np.zeros(d.shape[0], dtype=np.float32)
    for b in range(d.shape[0]):
        row, col = linear_sum_assignment(d[b])
        costs[b] = d[b][row, col].sum() / min(d.shape[1], d.shape[2])
    return float(np.mean(costs))


def emd_sinkhorn(pred: torch.Tensor, gt: torch.Tensor, epsilon: float = 0.01,
                 iters: int = 100) -> torch.Tensor:
    """Entropy-regularised optimal-transport cost between pred (B, N, 3)
    and gt (B, M, 3) with uniform marginals, averaged over the batch: a
    device-side approximation of :func:`emd` (log-domain Sinkhorn, ``iters``
    iterations at regularisation ``epsilon``)."""
    B, N, _ = pred.shape
    M = gt.shape[1]
    d = torch.sqrt(torch.clamp(square_distance(pred, gt), min=0.0))
    logK = -d / epsilon  # (B, N, M)
    log_a = torch.full((B, N), -float(np.log(N)), dtype=d.dtype, device=d.device)
    log_b = torch.full((B, M), -float(np.log(M)), dtype=d.dtype, device=d.device)
    f = torch.zeros_like(log_a)
    g = torch.zeros_like(log_b)
    for _ in range(iters):
        f = log_a - torch.logsumexp(logK + g[:, None, :], dim=2)
        g = log_b - torch.logsumexp(logK + f[:, :, None], dim=1)
    P = torch.exp(logK + f[:, :, None] + g[:, None, :])
    cost = torch.sum(P * d, dim=(1, 2)) / torch.sum(P, dim=(1, 2))
    return cost.mean()


def fscore(pred: torch.Tensor, gt: torch.Tensor, threshold: float = 0.1
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """F-score at a distance threshold (reference ``util/evaluation.py:
    28-52``): pred, gt (N, 3) single clouds -> (fscore, precision,
    recall)."""
    d = torch.sqrt(torch.clamp(
        square_distance(pred[None].float(), gt[None].float())[0], min=0.0))
    recall = (d.min(dim=0).values < threshold).float().mean()     # gt -> pred
    precision = (d.min(dim=1).values < threshold).float().mean()  # pred -> gt
    total = recall + precision
    f = torch.where(total > 0, 2 * recall * precision / total,
                    torch.zeros_like(total))
    return f, precision, recall


def topk_accuracy(output: torch.Tensor, target: torch.Tensor,
                  ks: Sequence[int] = (1,)) -> List[torch.Tensor]:
    """Top-k accuracy in percent (reference ``util/evaluation.py:13-26``):
    output (B, C) scores, target (B,) int labels.  Equal scores rank by
    the lowest class index, as ``jax.lax.top_k`` ranks them (a stable
    descending sort; ``torch.topk`` promises no order among ties)."""
    order = torch.sort(output, dim=1, descending=True, stable=True).indices
    res = []
    for k in ks:
        pred = order[:, :k]  # (B, k)
        correct = (pred == target[:, None]).any(dim=1)
        res.append(correct.float().mean() * 100.0)
    return res
