"""The SDM's work, counted from its widths alone.

Products are multiply-adds of the model's matrix products (every Dense
layer and 1x1 convolution, and the attention's logits and weighted sums)
that its result depends on; a FLOP is two of them.  Selections (FPS, ball
query, 3-NN), normalisations and activations are not counted.  The counts
follow the published model (``perfbench/reference/sdm.py``), so they read the
same work whatever implements it: a kernel that fuses, splits or recomputes
changes the time, never the count.
"""

from __future__ import annotations

from perfbench.reference.sdm import Widths


def _chain(rows: int, fin: int, outs) -> int:
    macs = 0
    for f in outs:
        macs += rows * fin * f
        fin = f
    return macs


def pointnet2_macs(w: Widths) -> int:
    """One cloud through PointNet++ (the SA stages over their ball groups,
    the FP stages over their targets, the head)."""
    macs, points = 0, w.pcd_points
    for npoint, _, cin, mlp in w.sa:
        macs += _chain(npoint * min(w.nsample, points), cin, mlp)  # ball groups
        points = npoint
    targets = {"fp4": w.sa[2][0], "fp3": w.sa[1][0], "fp2": w.sa[0][0],
               "fp1": w.pcd_points}
    for name, cin, mlp in Widths.FP:
        macs += _chain(targets[name], cin, mlp)
    return macs + _chain(w.pcd_points, 128, [128, w.pcd_dim])


def encode_macs(w: Widths) -> int:
    """One scene's conditioning: text and category MLPs, both backbones,
    the cross-attention's weights, the translation and the rank-1
    attention over every object cloud."""
    D, N, O, H = w.latent_dim, w.pcd_points, w.max_objs, w.n_head
    tp, E = w.translation_params, w.latent_dim
    macs = _chain(1, w.clip_dim, [w.clip_dim // 2, 2 * D, D])
    macs += _chain(1, D, [D // 2, D // 4, w.max_cats])
    macs += _chain(O, w.max_cats, [w.cat_emb])
    macs += _chain(N, 3, [64, 64]) + _chain(w.vert_dims, 64, [64, 3])  # POSA
    macs += O * pointnet2_macs(w)
    macs += E * E + O * w.cat_emb * E + O * E  # q, k, logits (E // H a head, H heads)
    macs += _chain(O, D + w.cat_emb, [D, tp])
    macs += O * (N * tp * tp + 2 * N * w.xyz_dim * tp  # q, k, v
                 + 2 * N * N * tp + N * tp * tp)       # logits, sums, out
    macs += O * N * (tp + w.xyz_dim) * w.xyz_dim
    return macs


def time_embed_macs(w: Widths) -> int:
    """One timestep's embedding (Linear, SiLU, Linear)."""
    return 2 * w.latent_dim * w.latent_dim


def step_macs(w: Widths, guiding: bool = False) -> int:
    """One scene through one denoiser step after the timestep embedding:
    the upsampling MLP on the step row, combine_extraction, then the
    point-wise input and output MLPs (twice with ``guiding``)."""
    D, N = w.latent_dim, w.pcd_points
    macs = _chain(2 * D, 1, [128, 512, N]) + N * 2 * D * D
    tail = (_chain(N, w.xyz_dim, [D // 2, D]) + _chain(N, 2 * D, [int(D * 1.5), D])
            + _chain(N, D, [D // 2, w.xyz_dim]))
    return macs + tail * (2 if guiding else 1)


def sample_flops(w: Widths, B: int, T: int) -> int:
    """One sampling request of B scenes and T steps: the encode, T steps
    and the T timestep embeddings."""
    return 2 * (B * encode_macs(w) + B * T * step_macs(w) + T * time_embed_macs(w))


def loop_flops(w: Widths, B: int, T: int) -> int:
    """The denoise loop of one request: T steps and their embeddings."""
    return 2 * (B * T * step_macs(w) + T * time_embed_macs(w))


def loop_weight_floats(w: Widths) -> int:
    D, N = w.latent_dim, w.pcd_points

    def dense(fin, outs):
        n = 0
        for f in outs:
            n += fin * f + f
            fin = f
        return n

    return (dense(1, [128, 512, N]) + dense(2 * D, [D]) + dense(w.xyz_dim, [D // 2, D])
            + dense(2 * D, [int(D * 1.5), D]) + dense(D, [D // 2, w.xyz_dim]))


def loop_bytes(w: Widths, B: int, T: int) -> int:
    """Bytes the denoise loop of one request must move, each input read once
    and each output written once, float32: the first image, the T noise
    draws, the conditioning, the step rows, the coefficients and the
    weights in; the sample and the last step's input out."""
    N, D = w.pcd_points, w.latent_dim
    floats = (B * N * 3 + T * B * N * 3 + B * N * 3 + B * T * 2 * D + T * 3
              + loop_weight_floats(w) + 2 * B * N * 3)
    return 4 * floats


def train_flops(w: Widths, B: int) -> int:
    """One train step of B scenes: the forward's products (the encode, the
    timestep embeddings and one step with its guiding points) times three,
    the forward and a backward of twice its work."""
    return 3 * 2 * B * (encode_macs(w) + time_embed_macs(w) + step_macs(w, guiding=True))
