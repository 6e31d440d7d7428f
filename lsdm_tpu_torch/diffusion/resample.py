"""Timestep samplers of training (reference ``diffusion/resample.py``).

Counterpart of ``lsdm_tpu/diffusion/resample.py``.  ``UniformSampler`` is
what LSDM training uses (``run/train_sdm.py:32``);
``LossSecondMomentResampler`` samples t in proportion to the root mean
square of its recent losses.  Under ``torch.distributed`` the losses of
every rank are gathered before the update, as the reference's
``dist.all_gather`` does (``resample.py:83-104``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch


def create_named_schedule_sampler(name: str, num_timesteps: int):
    """(reference ``resample.py:8-21``)"""
    if name == "uniform":
        return UniformSampler(num_timesteps)
    if name == "loss-second-moment":
        return LossSecondMomentResampler(num_timesteps)
    raise NotImplementedError(f"unknown schedule sampler: {name}")


class ScheduleSampler:
    """An importance-sampled distribution over timesteps (reference
    ``resample.py:24-59``)."""

    def weights(self) -> np.ndarray:
        raise NotImplementedError

    def sample(self, batch_size: int, generator: Optional[torch.Generator] = None,
               device=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """(t (B,) int64, importance weights 1 / (T p(t)) (B,) float32)."""
        w = self.weights()
        p = w / np.sum(w)
        t = torch.multinomial(torch.as_tensor(p), batch_size, replacement=True,
                              generator=generator)
        weights = torch.as_tensor(1.0 / (len(p) * p), dtype=torch.float32)[t]
        return t.to(device), weights.to(device)


class UniformSampler(ScheduleSampler):
    def __init__(self, num_timesteps: int):
        self.num_timesteps = num_timesteps
        self._weights = np.ones([num_timesteps], dtype=np.float64)

    def weights(self) -> np.ndarray:
        return self._weights


class LossAwareSampler(ScheduleSampler):
    def update_with_local_losses(self, local_ts, local_losses) -> None:
        """Update from this rank's (t, loss) pairs and, under
        ``torch.distributed``, every other rank's (reference
        ``resample.py:71-104``)."""
        ts = torch.as_tensor(local_ts).detach().cpu().tolist()
        losses = torch.as_tensor(local_losses).detach().cpu().tolist()
        dist = torch.distributed
        if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
            gathered = [None] * dist.get_world_size()
            dist.all_gather_object(gathered, (ts, losses))
            ts = [t for rank_ts, _ in gathered for t in rank_ts]
            losses = [x for _, rank_losses in gathered for x in rank_losses]
        self.update_with_all_losses(ts, losses)

    def update_with_all_losses(self, ts: Sequence[int], losses: Sequence[float]) -> None:
        raise NotImplementedError


class LossSecondMomentResampler(LossAwareSampler):
    """(reference ``resample.py:124-154``)"""

    def __init__(self, num_timesteps: int, history_per_term: int = 10,
                 uniform_prob: float = 0.001):
        self.num_timesteps = num_timesteps
        self.history_per_term = history_per_term
        self.uniform_prob = uniform_prob
        self._loss_history = np.zeros([num_timesteps, history_per_term], dtype=np.float64)
        self._loss_counts = np.zeros([num_timesteps], dtype=np.int64)

    def weights(self) -> np.ndarray:
        if not self._warmed_up():
            return np.ones([self.num_timesteps], dtype=np.float64)
        weights = np.sqrt(np.mean(self._loss_history ** 2, axis=-1))
        weights /= np.sum(weights)
        weights *= 1 - self.uniform_prob
        weights += self.uniform_prob / len(weights)
        return weights

    def update_with_all_losses(self, ts: Sequence[int], losses: Sequence[float]) -> None:
        for t, loss in zip(ts, losses):
            if self._loss_counts[t] == self.history_per_term:
                self._loss_history[t, :-1] = self._loss_history[t, 1:]
                self._loss_history[t, -1] = loss
            else:
                self._loss_history[t, self._loss_counts[t]] = loss
                self._loss_counts[t] += 1

    def _warmed_up(self) -> bool:
        return bool((self._loss_counts == self.history_per_term).all())
