"""K9's host plan and the step sampler's cache of its loop, on the CPU.

K9's tile kernel (``csrc/denoise_step.cu``) gives each cluster of
``step_plan(B, N, occupancy)`` blocks a tile of 32 point rows; each block
computes a column slice (``col_slice``) of every layer for all of the
tile's rows and updates the rows ``r % cluster == rank``.  These tests
hold the plan and that decomposition (every output column and every row
once), and the key under which ``sample_sdm(fused_step="step")`` keeps its
loop (on CUDA the captured graph) for a model.  On the card the plan reads
the device's occupancy of the tile kernel (``step_occupancy``); here it is
given the one an NVIDIA H100 80GB HBM3 reported at the flagship width.
"""

import pytest
import torch

from lsdm_tpu_torch.config import SDMConfig
from lsdm_tpu_torch.diffusion.schedule import make_schedule
from lsdm_tpu_torch.models import sampling
from lsdm_tpu_torch.models.sdm import SceneDiffusionModel
from lsdm_tpu_torch.ops import denoise
from lsdm_tpu_torch.weights import init_weights

FLAGSHIP_WIDTHS = (256, 128, 64, 128, 192, 128, 64)  # 2D, D, DH, D, 1.5D, D, DH2
# clusters of the tile kernel of 1..8 blocks an H100 runs at once at the
# flagship width (cudaOccupancyMaxActiveClusters through step_occupancy,
# profile_kernels.py --step_sweep): one ~217 KB block an SM, clusters
# within a GPC
H100 = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15}


@pytest.mark.parametrize("N", [64, 1000, 1024, 4096])
@pytest.mark.parametrize("B", range(1, 9))
def test_step_plan_fills_its_waves_and_covers_every_row_once(B, N):
    c = denoise.step_plan(B, N, H100)
    assert c in denoise.STEP_CLUSTERS
    tiles = B * -(-N // denoise.STEP_TILE_ROWS)
    capacity = H100[c]  # clusters the card runs at once
    waves = -(-tiles // capacity)
    # no other size takes fewer waves of a cheaper block
    for other in denoise.STEP_CLUSTERS:
        w = -(-tiles // H100[other])
        assert (waves * (denoise.STEP_FIXED + 1 / c)
                <= w * (denoise.STEP_FIXED + 1 / other) + 1e-12)
    # a plan of one wave at a 32-tile scene keeps most of the card busy
    if waves == 1 and tiles >= 32:
        assert tiles * c >= 96
    # the update: each point row of each scene by exactly one block
    seen = torch.zeros(B, N, dtype=torch.int32)
    for b in range(B):
        for t in range(-(-N // 32)):
            for rank in range(c):
                for r in range(32):
                    if r % c == rank and t * 32 + r < N:
                        seen[b, t * 32 + r] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("cluster", denoise.STEP_CLUSTERS)
@pytest.mark.parametrize("fout", list(FLAGSHIP_WIDTHS) + [3, 8, 24, 32, 37])
def test_col_slices_cover_every_column_once_on_16_bytes(cluster, fout):
    cols = []
    for rank in range(cluster):
        lo, hi = denoise.col_slice(fout, cluster, rank)
        assert (lo % 4 == 0 or lo == hi) and lo <= hi <= fout  # 16-byte copies
        cols += range(lo, hi)
    assert cols == list(range(fout))


def test_flagship_plan_is_the_sweeps_fastest():
    # the sizes the sweep at N = 1024 timed fastest, b1..b8 (PERF.md §6):
    # 32 tiles at b1 take clusters of 3 (96 blocks in one wave; 32 clusters
    # of 4 need two waves of 30), 256 at b8 one block each
    assert [denoise.step_plan(b, 1024, H100) for b in range(1, 9)] == [
        3, 2, 1, 1, 2, 2, 1, 1]
    assert denoise.col_slice(256, 4, 3) == (192, 256)
    assert denoise.col_slice(256, 3, 2) == (176, 256)


def test_step_plan_takes_only_sizes_the_device_runs():
    # a card that runs no cluster of 3 or more: the plan stays within 1-2
    small = {1: 4, 2: 2, 3: 0, 4: 0, 5: 0, 6: 0, 7: 0, 8: 0}
    assert all(denoise.step_plan(b, n, small) in (1, 2)
               for b in range(1, 9) for n in (64, 1024))
    with pytest.raises(ValueError, match="no cluster"):
        denoise.step_plan(1, 1024, dict.fromkeys(denoise.STEP_CLUSTERS, 0))
    with pytest.raises(ValueError, match="scenes and points"):
        denoise.step_plan(0, 1024, H100)


def _model():
    cfg = SDMConfig(clip_dim=32, latent_dim=16, cat_emb=8, n_head=4,
                    vert_dims=24, pcd_points=32)
    return init_weights(SceneDiffusionModel(cfg), 0).eval()


def test_step_loop_is_kept_per_shape_clip_and_weights():
    model = _model()
    cpu = torch.device("cpu")
    loop = sampling.step_loop(model, 1, 32, 4, cpu, False)
    assert sampling.step_loop(model, 1, 32, 4, cpu, False) is loop  # kept
    for other in ((2, 32, 4, False), (1, 32, 5, False), (1, 32, 4, True)):
        assert sampling.step_loop(model, *other[:3], cpu, other[3]) is not loop
    key = denoise.step_params_key(model)
    with torch.no_grad():  # an in-place update of the weights
        model.output_process.pose_final[2].bias.add_(1.0)
    assert denoise.step_params_key(model) != key
    fresh = sampling.step_loop(model, 1, 32, 4, cpu, False)
    assert fresh is not loop
    # the loop of the older weights at that shape is dropped
    assert sum(k[1:5] == (1, 32, 4, False)
               for k in sampling._STEP_LOOPS[model]) == 1
    # a loop kept for one model is not another's
    assert sampling.step_loop(_model(), 1, 32, 4, cpu, False) is not fresh


def test_step_loop_key_follows_the_factory(monkeypatch):
    # a sampler that swaps the loop's factory (chip_smoke.plain_versions)
    # gets that factory's loop, not one kept from the other
    model = _model()
    cpu = torch.device("cpu")
    loop = sampling.step_loop(model, 1, 32, 4, cpu, False)
    monkeypatch.setattr(sampling, "make_denoise_step_loop",
                        denoise.make_denoise_step_loop_plain)
    plain = sampling.step_loop(model, 1, 32, 4, cpu, False)
    assert plain is not loop
    assert plain.args[0].func is denoise.denoise_step_plain


def test_step_sampler_samples_twice_from_its_kept_loop():
    model = _model()
    sched = make_schedule("cosine", 3)
    g = torch.Generator().manual_seed(0)
    mask = torch.zeros(1, 9)
    mask[:, 1:4] = 1.0
    cats = torch.nn.functional.one_hot(torch.randint(0, 13, (1, 9), generator=g),
                                       13).float()
    args = (mask, torch.randn(1, 9, 32, 3, generator=g), cats,
            torch.randn(1, 32, generator=g))
    x_init = torch.randn(1, 32, 3, generator=g)
    noise = torch.randn(3, 1, 32, 3, generator=g)
    first = sampling.sample_sdm(model, sched, *args, fused_step="step",
                                x_init=x_init, noise=noise)
    loops = dict(sampling._STEP_LOOPS[model])
    second = sampling.sample_sdm(model, sched, *args, fused_step="step",
                                 x_init=x_init, noise=noise)
    assert dict(sampling._STEP_LOOPS[model]) == loops  # nothing built anew
    assert torch.equal(first[0], second[0])
    chain = sampling.sample_sdm(model, sched, *args, fused_step="chain",
                                x_init=x_init, noise=noise)
    assert torch.equal(first[0], chain[0])


def test_step_graph_refuses_the_cpu():
    p = denoise.extract_step_params(_model())
    with pytest.raises(ValueError, match="CUDA"):
        denoise.DenoiseStepGraph(p, 1, 32, 4, torch.device("cpu"))
