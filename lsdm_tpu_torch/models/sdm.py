"""SceneDiffusionModel — the multi-conditional denoiser.

Counterpart of ``lsdm_tpu/models/sdm.py`` (reference ``model/sdm.py:18-218``),
with the same interface: text arrives pre-encoded as ``text_emb``
(B, clip_dim); the forward factors into :meth:`encode_conditioning`
(everything that depends only on mask, objects, categories and text) and
:meth:`denoise_from_cond` (the x_t/t-dependent tail), so a sampler encodes
the conditioning once and reuses it across all T steps.

Reference quirks reproduced on purpose (trained weights depend on them):

  * the float 0/1 object mask is ADDED to the cross-attention logits
    (``model/sdm.py:180-182``), a +1 bias for given objects;
  * the (B, 3072, 9) -> (B, 9, 1024, 3) and (B, 9, 1024, 3) ->
    (1024, 3, B, 9) reshapes (``model/sdm.py:193,199``) scramble the
    object and feature axes in row-major order instead of transposing;
  * ``OutputProcess`` ends in GELU and ``predict_cat`` in Softmax.

Module and parameter names follow the reference ``state_dict``.  The
object backbone is PointNet++ or, with ``pcd_backbone_type="DGCNN"``,
``models/dgcnn.py``; the human backbone POSA's decoder or, with
``human_backbone_type="P2R"``, the STGCN of ``models/stgcn.py``, which
normalises with batch statistics in training as the object backbone does
(JAX ``models/sdm.py:96-118,180-183``).  ``ball_impl`` and ``bn_dtype``
select among PointNet++'s paths only; ``pcd_attention`` takes K4 (K5) by
its own gates whatever the backbones.
``cfg.dtype`` "bfloat16" computes in bf16 over float32 parameters with the
JAX module's casts (``lsdm_tpu/models/sdm.py:71-152``): every submodule in
that dtype, ``cfg.bn_dtype`` for the backbone's BatchNorms, the category
probabilities and ``x0`` / ``guiding`` returned float32; its fused eval
encode runs K7's and K8's bf16 modes.  ``ball_impl`` "fused" makes the
eval encode the fused kernels' (K7, K8 in the backbone, K4 in
``pcd_attention``).  In training (``model.train()``, the JAX
``train=True``) the backbone normalises with batch statistics and drops
out in its head, and ``attn_impl="pallas"`` makes ``pcd_attention`` the
rank-1 kernels K4/K5; the category head sees ``enc_text`` detached, as
JAX's ``stop_gradient`` has it.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import torch
from torch import nn

from lsdm_tpu_torch.config import SDMConfig
from lsdm_tpu_torch.diffusion.gaussian import DenoiserOutput
from lsdm_tpu_torch.models.common import (
    InputProcess, OutputProcess, PositionalEncoding, TimestepEmbedder,
    compute_dtype, mlp)
from lsdm_tpu_torch.models.dgcnn import DGCNN
from lsdm_tpu_torch.models.pointnet2 import PointNet2Backbone
from lsdm_tpu_torch.models.posa import POSADecoderBackbone
from lsdm_tpu_torch.models.stgcn import STGCN
from lsdm_tpu_torch.ops.attention import TorchMultiheadAttention, wide
from lsdm_tpu_torch.parallel.mesh import (
    BatchShard, batch_stats_over, cloud_shard_map)


class CondCache(NamedTuple):
    """Conditioning features that are constant across sampler steps."""

    enc_text: torch.Tensor  # (B, 1, D)
    out_cat: torch.Tensor  # (B, 1, max_cats) softmax probabilities
    cond_pcd: torch.Tensor  # (B, N, 3): (weighted object features + human) / 2


def _stats(shard: Optional[BatchShard], clouds: bool):
    """Where a sharded forward's train-mode BatchNorms take statistics: over
    the mesh for the split clouds of the object backbone, over the data
    axis for what the ranks of a data index share (the human backbone, or
    unsplit clouds)."""
    if shard is None:
        return contextlib.nullcontext()
    m = shard.mesh
    return batch_stats_over(m.group if clouds and shard.split_clouds
                            else m.data_group)


def _per_cloud(shard: Optional[BatchShard], fn, *arrays):
    """``fn`` over the clouds: this rank's part of them under a split
    (``cloud_shard_map``), else all of them."""
    if shard is None or not shard.split_clouds:
        return fn(*arrays)
    return cloud_shard_map(fn, shard.mesh, *arrays)


class SceneDiffusionModel(nn.Module):
    def __init__(self, cfg: SDMConfig):
        super().__init__()
        self.cfg = cfg
        D = cfg.latent_dim
        N = cfg.pcd_points
        dt = self.compute_dtype = compute_dtype(cfg.dtype)
        self.sequence_pos_encoder = PositionalEncoding(D)
        self.embed_timestep = TimestepEmbedder(D, dt)
        self.embed_text = mlp(cfg.clip_dim, (cfg.clip_dim // 2, D * 2, D), "gelu", dt)
        self.embed_cat = mlp(cfg.max_cats, (cfg.cat_emb,), "gelu", dt)
        self.predict_cat = mlp(D, (D // 2, D // 4, cfg.max_cats), "gelu", dt)
        self.attn_layer = TorchMultiheadAttention(
            D, cfg.n_head, kdim=cfg.cat_emb, vdim=N * cfg.pcd_dim, dtype=dt)
        self.translation_layer = mlp(D + cfg.cat_emb, (D, cfg.translation_params),
                                     "gelu", dt)
        self.point_wise_trans_layer = mlp(
            cfg.translation_params + cfg.xyz_dim, (cfg.xyz_dim,), "gelu", dt)
        self.pcd_attention = TorchMultiheadAttention(
            cfg.translation_params, cfg.translation_params,
            kdim=cfg.xyz_dim, vdim=cfg.xyz_dim, dtype=dt)
        if cfg.pcd_backbone_type == "DGCNN":
            self.pcd_backbone = DGCNN(emb_dims=cfg.clip_dim,
                                      output_channels=N * cfg.xyz_dim, dtype=dt)
        else:
            self.pcd_backbone = PointNet2Backbone(
                out_dim=cfg.pcd_dim,
                sa_npoints=(N, max(N // 4, 4), max(N // 16, 2), max(N // 64, 1)),
                sa_nsample=min(32, N), fps_mode=cfg.fps_mode,
                ball_impl=cfg.ball_impl, dtype=dt,
                bn_dtype=compute_dtype(cfg.bn_dtype))
        if cfg.human_backbone_type == "P2R":
            self.human_backbone = STGCN(joint_num=N, out_channels=N * cfg.xyz_dim,
                                        dtype=dt)
        else:
            self.human_backbone = POSADecoderBackbone(cfg.vert_dims, N, dtype=dt)
        self.upsampling_layer = mlp(1, (128, 512, N), "gelu", dt)
        self.combine_extraction = mlp(2 * D, (D,), "gelu", dt)
        self.input_process = InputProcess(cfg.xyz_dim, D, dt)
        self.output_process = OutputProcess(cfg.xyz_dim, D, N, dt)

    # ------------------------------------------------------------------
    def encode_conditioning(
        self,
        mask: torch.Tensor,  # (B, max_objs) float 0/1, slot 0 = human (0)
        given_objs: torch.Tensor,  # (B, max_objs, N, 3), slot 0 = human
        given_cats: torch.Tensor,  # (B, max_objs, max_cats) one-hot
        text_emb: torch.Tensor,  # (B, clip_dim) frozen text features
        dropout_mask: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        shard: Optional[BatchShard] = None,
    ) -> CondCache:
        """Reference ``model/sdm.py`` :145-161 (text/category embeddings,
        category head) and :169-204 (backbones, attentions, translation).
        ``dropout_mask`` / ``generator``: the object backbone's dropout in
        training (``PointNet2Backbone.forward``: one keep-mask;
        ``DGCNN.forward``: a pair).  ``shard``: the inputs are this rank's
        slice of a global batch (``parallel/mesh.py:BatchShard``), and the
        result is that slice of the global batch's result: the mask is read
        where the global batch's indices point, the train-mode BatchNorms
        take the global batch's statistics and, with ``split_clouds``, the
        rank runs its part of its clouds through the object backbone and
        ``pcd_attention`` (K1-K5 per shard), gathered over the model axis;
        a given ``dropout_mask`` covers this rank's data slice of the
        clouds."""
        cfg = self.cfg
        B, num_obj, num_points, xyz = given_objs.shape
        D = cfg.latent_dim
        if shard is not None and shard.split_clouds and getattr(
                self.pcd_backbone, "impl", None) in ("fused", "sg"):
            raise ValueError(
                f"ball_impl={cfg.ball_impl!r} under an object sharding: JAX "
                "resolves it to 'auto' there (lsdm_tpu/models/sdm.py:141-143); "
                "build the model with parallel.mesh.sharded_config(cfg)")

        # float32 text features, as JAX casts them, in the weights' dtype
        w = self.embed_text[0].weight
        enc_text = self.embed_text(text_emb.float().to(w.dtype))[:, None, :]  # (B, 1, D)
        # the category head on detached text features (reference :157),
        # its softmax in at least float32 (JAX's astype)
        out_cat = torch.softmax(wide(self.predict_cat(enc_text.detach())), dim=2)
        emb_cat = self.embed_cat(given_cats)  # (B, num_obj, cat_emb)

        with _stats(shard, clouds=False):
            hm_out = self.human_backbone(given_objs[:, 0].detach())  # (B, N, 3)
        objs_flat = given_objs.reshape(B * num_obj, num_points, xyz).contiguous()
        with _stats(shard, clouds=True):
            pcd_out = _per_cloud(
                shard, lambda o, m: self.pcd_backbone(o, m, generator),
                objs_flat, dropout_mask)
        pcd_out = pcd_out.reshape(B, num_obj, num_points * cfg.pcd_dim)

        # text x category x cloud attention with the additive float mask,
        # tiled head-major and read batch-major: scene b's head h takes the
        # mask row (b * H + h) mod B of the global batch (unsharded: this
        # batch, whose first scene is 0)
        gmask, first = ((mask.float(), 0) if shard is None
                        else (shard.global_mask(mask), shard.offset(B)))
        H = cfg.n_head
        rows = torch.arange(first * H, (first + B) * H, device=mask.device)
        attn_mask = gmask[rows % gmask.shape[0]][:, None, :]
        _, attn_w = self.attn_layer(enc_text, emb_cat, pcd_out,
                                    attn_mask=attn_mask)  # (B, 1, num_obj)

        enc_text_rep = enc_text.expand(B, num_obj, D)
        translation = self.translation_layer(
            torch.cat([emb_cat, enc_text_rep], dim=-1))  # (B, num_obj, 12)
        translation = translation[:, :, None, :].expand(
            B, num_obj, cfg.pcd_points, cfg.translation_params
        ).reshape(B * num_obj, cfg.pcd_points, cfg.translation_params)

        # the reference's scrambling reshapes (torch reshape of a permuted
        # tensor == row-major reshape of the transposed array)
        pcd_out = pcd_out.transpose(1, 2) * attn_w.to(pcd_out.dtype)  # (B, N*pcd_dim, num_obj)
        pcd_out = pcd_out.reshape(B, num_obj, num_points, cfg.pcd_dim)
        pcd_trans = pcd_out.reshape(B * num_obj, cfg.pcd_points, cfg.xyz_dim)
        # head_dim 1: with ball_impl "fused" the K4 kernel in eval, with
        # attn_impl "pallas" the K4/K5 pair in training
        pcd_trans = _per_cloud(shard, lambda q, kv: self.pcd_attention(
            q, kv, kv, need_weights=False,
            fused=(cfg.ball_impl == "fused" and not self.training),
            fused_train=(cfg.attn_impl == "pallas" and self.training))[0],
            translation, pcd_trans.contiguous())
        pcd_trans = pcd_trans.reshape(B, num_obj, num_points,
                                      cfg.translation_params)
        pcd_out = self.point_wise_trans_layer(
            torch.cat([pcd_out, pcd_trans], dim=-1))  # (B, num_obj, N, 3)
        # the reference's (B, O, N, 3) -> (N, 3, B, O) times the mask: each
        # entry takes the mask entry at its flat index mod B * O, of the
        # global batch
        start = first * pcd_out[0].numel()
        flat = torch.arange(start, start + pcd_out.numel(), device=mask.device)
        pcd_out = pcd_out * gmask.reshape(-1)[flat % gmask.numel()].reshape(
            pcd_out.shape).to(pcd_out.dtype)
        pcd_out = pcd_out.reshape(B, num_obj, num_points, -1).sum(dim=1)
        cond_pcd = (pcd_out + hm_out) / 2  # (reference :203)
        return CondCache(enc_text=enc_text, out_cat=out_cat, cond_pcd=cond_pcd)

    # ------------------------------------------------------------------
    def _timestep_emb(self, timesteps: torch.Tensor) -> torch.Tensor:
        return self.embed_timestep(timesteps, self.sequence_pos_encoder.pe)

    def timestep_cond_emb(self, cond: CondCache, timesteps: torch.Tensor
                          ) -> torch.Tensor:
        """Per-point fused (timestep, text) embedding (B, N, D) — depends
        only on t and the text (reference :141-142, :164-167)."""
        emb = self.step_emb2(cond, timesteps)[:, :, None]  # (B, 2D, 1)
        emb = self.upsampling_layer(emb).transpose(1, 2)  # (B, N, 2D)
        return self.combine_extraction(emb)

    def step_emb2(self, cond: CondCache, timesteps: torch.Tensor
                  ) -> torch.Tensor:
        """(B, 2D) concat of the timestep and text embeddings, the input
        of the upsampling MLP."""
        return torch.cat([self._timestep_emb(timesteps), cond.enc_text],
                         dim=-1)[:, 0]

    def step_emb2_table(self, cond: CondCache, timesteps: torch.Tensor
                        ) -> torch.Tensor:
        """:meth:`step_emb2` for a sequence of T timesteps shared by the
        batch, as one (B, T, 2D) table."""
        emb_ts = self._timestep_emb(timesteps)[:, 0]  # (T, D)
        B, T = cond.enc_text.shape[0], emb_ts.shape[0]
        return torch.cat([emb_ts[None].expand(B, T, -1),
                          cond.enc_text.expand(B, T, -1)], dim=-1)

    def denoise_with_emb(self, cond: CondCache, emb: torch.Tensor,
                         x: torch.Tensor) -> torch.Tensor:
        """x_t-dependent core (reference :204-212), at least float32."""
        return wide(self.output_process(self.input_process(x + cond.cond_pcd, emb)))

    def guiding_from_emb(self, cond: CondCache, emb: torch.Tensor
                         ) -> torch.Tensor:
        """Guiding points (reference :213-217), x_t-independent, at least
        float32."""
        return wide(self.output_process(self.input_process(cond.cond_pcd, emb)))

    def denoise_from_cond(self, cond: CondCache, x: torch.Tensor,
                          timesteps: torch.Tensor) -> DenoiserOutput:
        """The t/x_t-dependent tail (reference :141-142, :164-167,
        :204-217)."""
        emb = self.timestep_cond_emb(cond, timesteps)
        return DenoiserOutput(x0=self.denoise_with_emb(cond, emb, x),
                              cat=cond.out_cat,
                              guiding=self.guiding_from_emb(cond, emb))

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                timesteps: torch.Tensor, given_objs: torch.Tensor,
                given_cats: torch.Tensor, text_emb: torch.Tensor,
                dropout_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                shard: Optional[BatchShard] = None) -> DenoiserOutput:
        cond = self.encode_conditioning(mask, given_objs, given_cats, text_emb,
                                        dropout_mask, generator, shard)
        return self.denoise_from_cond(cond, x, timesteps)
