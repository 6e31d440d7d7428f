"""K6 bf16's second pass as far as the CPU reaches it: the bf16 copies of the
tail's weights in the layout ``csrc/denoise_chain_bf16.cu`` reads, made once
per model, and the plan of a launch (warps a tile, tiles a block).  The
kernel itself runs only on the card (``tests/test_torch_cuda.py``)."""

import pytest
import torch

from lsdm_tpu_torch.config import SDMConfig
from lsdm_tpu_torch.models.sdm import SceneDiffusionModel
from lsdm_tpu_torch.ops import denoise
from lsdm_tpu_torch.weights import init_weights
from test_torch_fused import TINY_KW

T_BF16 = torch.bfloat16
TAIL = ("wp0", "wp2", "wx0", "wx2", "wo0", "wo2")


@pytest.mark.parametrize("D", [16, 128])
def test_bf16_tail_copies_are_the_rounded_weights_in_the_kernel_layout(D):
    """Each of pass 2's six copies is its layer's weight as rounded by
    ``bf16_step_params``, transposed to (out, k) rows, bf16, zero-padded to
    the compiled widths with each row an odd number of 16-byte chunks; made
    once per model and weights (the same tensors on a second
    ``step_params`` call), and handed to the kernel after pass 1's four."""
    model = init_weights(SceneDiffusionModel(SDMConfig(
        **{**TINY_KW, "latent_dim": D}, dtype="bfloat16")), 0).eval()
    p = denoise.step_params(model, T_BF16)
    ops = p.operands
    weights = (p.wp0_t, p.wp2_t, p.wx0_t[:D], p.wx2_t, p.wo0_t, p.wo2_t)
    shapes = ((64, 24), (128, 72), (192, 136), (128, 200), (64, 136), (8, 72))
    for name, w, shape in zip(TAIL, weights, shapes):
        o = getattr(ops, name)
        k, n = w.shape
        assert o.dtype == T_BF16 and o.is_contiguous() and o.shape == shape, name
        assert (o.shape[1] // 8) % 2 == 1, name  # odd 16-byte chunks a row
        assert torch.equal(o[:n, :k].float(), w.t()), name  # w is bf16-exact
        assert not o[n:].any() and not o[:, k:].any(), name
    assert denoise.step_params(model, T_BF16).operands is ops
    ptrs = list(denoise._pointers(p, True))
    assert len(ptrs) == 30 and ptrs[24:] == [getattr(ops, f).data_ptr() for f in TAIL]


def test_bf16_tail_past_the_compiled_widths_is_refused():
    """A tail wider than the kernel's (here D = 136, the float32 mode's
    largest model width) cannot be laid out: the copies raise, naming the
    widths it takes."""
    model = init_weights(SceneDiffusionModel(SDMConfig(
        **{**TINY_KW, "latent_dim": 136}, dtype="bfloat16")), 0).eval()
    p = denoise.step_params(model, T_BF16)
    with pytest.raises(ValueError, match="DH <= 64, D <= 128, D15 <= 192, DH2 <= 64"):
        p.operands


@pytest.mark.parametrize("B,N,sms,plan", [
    (1, 1024, 132, (8, 1)),    # 64 tiles: one a block, 8 warps each
    (2, 1024, 132, (8, 1)),    # 128 tiles: still one wave of one-tile blocks
    (3, 1024, 132, (4, 2)),    # 192 tiles: 96 blocks of two, 4 warps a tile
    (4, 1024, 132, (4, 2)),    # 256 tiles: 128 blocks of two
    (5, 1024, 132, (4, 3)),    # 320 tiles: 107 blocks of three
    (6, 1024, 132, (4, 3)),    # 384 tiles: 128 blocks of three
    (7, 1024, 132, (4, 4)),    # 448 tiles: 112 blocks of 16 warps
    (8, 1024, 132, (4, 4)),    # 512 tiles: 128 blocks of 16 warps
    (16, 1024, 132, (4, 4)),   # 1024 tiles: two waves of the largest blocks
    (8, 1000, 132, (4, 4)),    # 63 tiles a scene, the last of 8 rows
    (2, 37, 132, (8, 1)),      # 3 tiles a scene, the last of 5 rows
    (8, 1024, 264, (4, 2)),    # twice the SMs: one wave of blocks of two
])
def test_chain_bf16_plan_at_each_batch(B, N, sms, plan):
    """The fewest tiles a block, up to 4, that make one wave of one block
    an SM; 8 warps a tile alone in its block, else 4, so no block exceeds
    the 16 warps the kernel takes."""
    assert denoise.chain_bf16_plan(B, N, sms) == plan
    warps, tpb = plan
    assert warps in (4, 8) and warps * tpb <= 16


def test_chain_bf16_plan_refuses_an_empty_launch():
    with pytest.raises(ValueError, match="scenes and points"):
        denoise.chain_bf16_plan(0, 1024)
    with pytest.raises(ValueError, match="scenes and points"):
        denoise.chain_bf16_plan(1, 0)
