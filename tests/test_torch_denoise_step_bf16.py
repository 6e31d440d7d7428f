"""K9 bf16 as far as the CPU reaches it: the bf16 operands of
``csrc/denoise_step_bf16.cu`` (made once per model, padded with zeros to
the widths the kernel is compiled for), the kernel's dataflow over them
transcribed in torch, and the plan of its tile launch.  The kernel itself
runs only on the card (``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from lsdm_tpu_torch.config import SDMConfig
from lsdm_tpu_torch.models.sdm import SceneDiffusionModel
from lsdm_tpu_torch.ops import denoise
from lsdm_tpu_torch.weights import init_weights
from test_torch_fused import TINY_KW

T_BF16 = torch.bfloat16
# an NVIDIA H100's blocks of the tile kernel at once for 1, 2 and 4 m16
# tiles a block (one block an SM: each takes over 114 KB of shared memory)
H100 = {1: 132, 2: 132, 4: 132}


def _rows(o):
    """A chunked operand (chunks, n, 72) back as its (n, 64 chunks) rows;
    each row's last 8 must be zeros."""
    assert o.dtype == T_BF16 and o.is_contiguous() and o.shape[2] == 72
    assert not o[..., 64:].any()
    return o[..., :64].transpose(0, 1).reshape(o.shape[1], -1)


def _params(D):
    model = init_weights(SceneDiffusionModel(SDMConfig(
        **{**TINY_KW, "latent_dim": D}, dtype="bfloat16")), 0).eval()
    return model, denoise.step_params(model, T_BF16)


@pytest.mark.parametrize("D", [16, 128])
def test_step_bf16_operands_are_the_rounded_weights_in_the_kernel_layout(D):
    """Each bf16 copy is its weight as ``bf16_step_params`` rounded it, as
    (out, k) rows at the compiled widths with zeros past the model's (the
    pose half of wx0 at k 0, the emb half at k 128), those the tile kernel
    streams cut into contiguous chunks of 64 k with rows padded to 72; the
    biases packed in order, zero-padded; made once per model and weights,
    and handed to the kernel in the C entry's order."""
    model, p = _params(D)
    ops = p.step_operands
    caps = denoise.STEP_BF16_CAPS
    N = p.w_up4.shape[0]
    assert ops.w2.dtype == T_BF16 and ops.w2.shape == (caps["U2"], caps["U0"])
    assert torch.equal(ops.w2[:, :p.w_up2.shape[1]].float(), p.w_up2)
    assert not ops.w2[:, p.w_up2.shape[1]:].any()
    wants = {"w4": (p.w_up4, (8, -(-N // 64) * 64)),
             "wc": (p.wc_t.t(), (4, 128)), "wp0": (p.wp0_t.t(), (1, 64)),
             "wp2": (p.wp2_t.t(), (1, 128)), "wx2": (p.wx2_t.t(), (3, 128)),
             "wo0": (p.wo0_t.t(), (2, 64)), "wo2": (p.wo2_t.t(), (1, 8))}
    for name, (w, shape) in wants.items():
        o = getattr(ops, name)
        assert o.shape[:2] == shape, name
        rows = _rows(o)
        n, k = w.shape
        assert torch.equal(rows[:n, :k].float(), w), name  # w is bf16-exact
        assert not rows[n:].any() and not rows[:, k:].any(), name
    d15 = p.wx0_t.shape[1]
    assert ops.wx0.shape == (4, 192, 72)
    wx0 = _rows(ops.wx0)
    assert torch.equal(wx0[:d15, :D].float(), p.wx0_t[:D].t())
    assert torch.equal(wx0[:d15, 128:128 + D].float(), p.wx0_t[D:].t())
    pad = torch.ones(192, 256, dtype=torch.bool)
    pad[:d15, :D] = pad[:d15, 128:128 + D] = False
    assert not wx0[pad].any()
    assert ops.bias.dtype == torch.float32 and ops.bias.shape == (1224,)
    at = 0
    for f, n in (("b_up2", 512), ("bc", 128), ("bp0", 64), ("bp2", 128),
                 ("bx0", 192), ("bx2", 128), ("bo0", 64), ("bo2", 8)):
        b = getattr(p, f).reshape(-1)
        assert torch.equal(ops.bias[at:at + b.numel()], b), f
        assert not ops.bias[at + b.numel():at + n].any(), f
        at += n
    assert denoise.step_params(model, T_BF16).step_operands is ops
    ptrs = list(denoise._step_bf16_pointers(p))
    assert ptrs == [t.data_ptr() for t in (p.w_up0, p.b_up0, ops.w2, ops.w4, p.b_up4,
                                           ops.bias, ops.wc, ops.wp0, ops.wp2, ops.wx0,
                                           ops.wx2, ops.wo0, ops.wo2)]


def _kernel_dataflow(x, noise, cpcd, e2, coefs, p, clip):
    """The tile kernel's arithmetic over its padded operands (their chunks
    read back as rows), in float64 on bf16-exact operands: u2^T (256, 512)
    with rows past 2D zero, u4 from the rows of w4 with b_up4 per row, emb
    into columns 128.. of Y beside p2, and each layer's output rounded to
    bf16 where the next reads it."""
    ops = p.step_operands
    r = lambda t: t.to(T_BF16).double()  # noqa: E731
    bias = ops.bias.double()
    cuts = np.cumsum([0, 512, 128, 64, 128, 192, 128, 64, 8])
    b_up2, bc, bp0, bp2, bx0, bx2, bo0, bo2 = (bias[a:b] for a, b in zip(cuts, cuts[1:]))
    B, N, D2 = x.shape[0], x.shape[1], e2.shape[1]
    u0t = torch.zeros(B, 256, 128, dtype=torch.float64)
    u0 = F.gelu(p.w_up0 * e2[:, None, :] + p.b_up0)  # (B, U0, 2D)
    u0t[:, :D2, :u0.shape[1]] = r(u0).transpose(1, 2)
    u2t = r(F.gelu(u0t @ ops.w2.double().t() + b_up2))  # (B, 256, 512)
    u2t[:, D2:] = 0
    u4 = r(F.gelu(_rows(ops.w4)[:N].double() @ u2t.transpose(1, 2)
                  + p.b_up4.double()))  # (B, N, 256)
    y = torch.zeros(B, N, 256, dtype=torch.float64)
    y[..., 128:] = r(F.gelu(u4 @ _rows(ops.wc).double().t() + bc))
    a = torch.zeros(B, N, 16, dtype=torch.float64)
    a[..., :3] = r(x + cpcd)
    h = r(torch.sigmoid(a @ _rows(ops.wp0)[:, :16].double().t() + bp0))
    y[..., :128] = r(torch.sigmoid(h @ _rows(ops.wp2).double().t() + bp2))
    h = r(torch.sigmoid(y @ _rows(ops.wx0).double().t() + bx0))
    h = r(torch.sigmoid(h @ _rows(ops.wx2).double().t() + bx2))
    h = r(F.gelu(h @ _rows(ops.wo0).double().t() + bo0))
    x0 = F.gelu(h @ _rows(ops.wo2).double().t() + bo2)[..., :3]
    if clip:
        x0 = x0.clamp(-1.0, 1.0)
    c = coefs.double()
    return ((c[0] * x0 + c[1] * x.double()) + c[2] * noise.double()).float()


@pytest.mark.parametrize("D,clip", [(16, True), (128, False)])
def test_step_bf16_operands_give_the_plain_step(D, clip):
    """The kernel's dataflow over the padded operands computes the plain
    bf16 step: the zeros of the padding add nothing (p2's and emb's padded
    columns, sigmoid(0) and gelu(b_up4), meet zero rows of wx0), within
    float32 sums in another order (a bf16 rounding of an activation may
    then fall the other way)."""
    _, p = _params(D)
    rs = np.random.RandomState(D)
    B, N = 2, p.w_up4.shape[0]
    t = lambda *s: torch.from_numpy(rs.randn(*s).astype(np.float32))  # noqa: E731
    args = (t(B, N, 3), t(B, N, 3), t(B, N, 3), t(B, 2 * D), torch.tensor([0.6, 0.7, 0.1]))
    got = _kernel_dataflow(*args, p, clip)
    want = denoise.denoise_step_plain(*args, p, clip, T_BF16)
    torch.testing.assert_close(got, want, atol=2e-2, rtol=0)
    assert (got - want).abs().mean() < 1e-3


def test_step_bf16_operands_past_the_caps_are_refused():
    """D = 144 (2D = 288) exceeds the compiled 2D of 256: the copies raise,
    naming the widths the kernel takes."""
    _, p = _params(144)
    with pytest.raises(ValueError, match="K9 bf16 takes D <= 128"):
        p.step_operands


@pytest.mark.parametrize("N", [1, 5, 37, 1000, 1024, 4096])
@pytest.mark.parametrize("B", range(1, 9))
def test_step_bf16_plan_covers_every_row_in_the_fewest_waves(B, N):
    mt = denoise.step_bf16_plan(B, N, H100)
    assert isinstance(mt, int) and mt in denoise.STEP_BF16_MTILES
    rows, tiles = 16 * mt, -(-N // (16 * mt))  # the C entry's grid (tiles, B)
    assert (tiles - 1) * rows < N <= tiles * rows

    def waves(m):
        return -(-B * -(-N // (16 * m)) // H100[m])

    assert all((waves(mt), mt) <= (waves(m), m) for m in denoise.STEP_BF16_MTILES)


@pytest.mark.parametrize("B,N,mt", [(1, 1024, 1), (2, 1024, 1), (3, 1024, 2),
                                    (4, 1024, 2), (8, 1024, 4), (8, 4096, 4)])
def test_step_bf16_plan_at_the_flagship_width(B, N, mt):
    """One wave of the smallest blocks while they make one, then larger."""
    assert denoise.step_bf16_plan(B, N, H100) == mt


def test_step_bf16_plan_refuses_an_empty_launch():
    with pytest.raises(ValueError, match="scenes and points"):
        denoise.step_bf16_plan(0, 1024, H100)
    with pytest.raises(ValueError, match="no block"):
        denoise.step_bf16_plan(1, 1024, {1: 0, 2: 0, 4: 0})
