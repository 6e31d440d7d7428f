"""The work counters against counts made by hand and by PyTorch's FLOP
counter over the plain reference, at small widths."""

from __future__ import annotations

import dataclasses

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench.reference import sdm as ref
from perfbench.reference import sdm_counts as counts

SMALL = ref.Widths(clip_dim=32, n_head=4, cat_emb=8, latent_dim=16, vert_dims=40,
                   pcd_points=64, max_cats=5, max_objs=3)


def _weights(w):
    g = torch.Generator().manual_seed(0)
    sd = {}
    for name, shape, kind in ref.param_spec(w):
        if kind == "pe":
            sd[name] = ref.positional_encoding(shape[-1], shape[0])
        elif kind == "count":
            sd[name] = torch.zeros((), dtype=torch.long)
        elif kind in ("ones", "stat_ones"):
            sd[name] = torch.ones(shape)
        else:
            sd[name] = torch.rand(shape, generator=g) * 0.2 - 0.1
    return sd


def _inputs(w, B):
    g = torch.Generator().manual_seed(1)
    mask = torch.zeros(B, w.max_objs)
    mask[:, 1:] = 1
    objs = torch.randn(B, w.max_objs, w.pcd_points, 3, generator=g)
    cats = torch.nn.functional.one_hot(torch.arange(B * w.max_objs).reshape(B, -1) % w.max_cats,
                                       w.max_cats).float()
    return mask, objs, cats, torch.randn(B, w.clip_dim, generator=g)


def test_step_by_hand():
    """D = 4, N = 8, 3 coordinates: the upsampling MLP on 8 rows (1 -> 128
    -> 512 -> 8), combine 8 x 8 -> 4, then 3 -> 2 -> 4, 8 -> 6 -> 4 and
    4 -> 2 -> 3 on 8 points."""
    w = dataclasses.replace(SMALL, latent_dim=4, pcd_points=8)
    up = 8 * (1 * 128 + 128 * 512 + 512 * 8)
    comb = 8 * 8 * 4
    tail = 8 * (3 * 2 + 2 * 4) + 8 * (8 * 6 + 6 * 4) + 8 * (4 * 2 + 2 * 3)
    assert counts.step_macs(w) == up + comb + tail
    assert counts.step_macs(w, guiding=True) == up + comb + 2 * tail
    assert counts.time_embed_macs(w) == 2 * 4 * 4


def test_loop_bytes_by_hand():
    w = dataclasses.replace(SMALL, latent_dim=4, pcd_points=8)
    B, T = 2, 5
    floats = (B * 8 * 3 * 3 + T * B * 8 * 3 + B * T * 8 + T * 3
              + counts.loop_weight_floats(w) + B * 8 * 3)
    assert counts.loop_bytes(w, B, T) == 4 * floats
    assert counts.loop_weight_floats(w) == ((128 + 128) + (128 * 512 + 512) + (512 * 8 + 8)
                                            + (8 * 4 + 4) + (3 * 2 + 2) + (2 * 4 + 4)
                                            + (8 * 6 + 6) + (6 * 4 + 4) + (4 * 2 + 2) + (2 * 3 + 3))


@pytest.mark.parametrize("B", [1, 2])
def test_encode_and_denoise_against_flop_counter(B):
    w, sd = SMALL, _weights(SMALL)
    P = ref.Precision()
    mask, objs, cats, text = _inputs(w, B)
    with FlopCounterMode(display=False) as fc:
        cond = ref.encode(P, sd, w, mask, objs, cats, text)
    # the rank-1 logits are an outer product (one multiply-add each, by the
    # 2 M N K convention), which einsum takes elementwise, so the counter
    # leaves them out
    N, tp = w.pcd_points, w.translation_params
    outer = 2 * B * w.max_objs * N * N * tp
    assert fc.get_total_flops() == 2 * B * counts.encode_macs(w) - outer
    t = torch.full((B,), 3)
    with FlopCounterMode(display=False) as fc:
        ref.denoise(P, sd, w, cond, torch.randn(B, w.pcd_points, 3), t)
    assert fc.get_total_flops() == 2 * B * (counts.step_macs(w, guiding=True)
                                            + counts.time_embed_macs(w))


def test_train_and_sample_totals():
    w = SMALL
    per_scene = counts.encode_macs(w) + counts.time_embed_macs(w) + counts.step_macs(w, True)
    assert counts.train_flops(w, 6) == 3 * 2 * 6 * per_scene
    assert counts.sample_flops(w, 8, 10) == 2 * (8 * counts.encode_macs(w)
                                                 + 8 * 10 * counts.step_macs(w)
                                                 + 10 * counts.time_embed_macs(w))
    assert counts.loop_flops(w, 8, 10) == counts.sample_flops(w, 8, 10) - 2 * 8 * counts.encode_macs(w)


def test_flagship_counts():
    """sdm_proxd at batch 8 and T = 1000: 4.44 TFLOP of loop products a
    batch (277 million multiply-adds a step and scene)."""
    w = ref.Widths()
    assert counts.step_macs(w) == 277_250_048
    assert counts.loop_flops(w, 8, 1000) == pytest.approx(4.44e12, rel=2e-3)
