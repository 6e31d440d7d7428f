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

Module and parameter names follow the reference ``state_dict``.  Only the
configuration of the sampling slices is built: the PointNet++ object
backbone, the POSA human backbone and float32 compute.  ``ball_impl``
"fused" makes the eval encode the fused kernels' (K7, K8 in the backbone,
K4 in ``pcd_attention``).  In training (``model.train()``, the JAX
``train=True``) the backbone normalises with batch statistics and drops
out in its head, and ``attn_impl="pallas"`` makes ``pcd_attention`` the
rank-1 kernels K4/K5; the category head sees ``enc_text`` detached, as
JAX's ``stop_gradient`` has it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from lsdm_tpu_torch.config import SDMConfig
from lsdm_tpu_torch.diffusion.gaussian import DenoiserOutput
from lsdm_tpu_torch.models.common import (
    InputProcess, OutputProcess, PositionalEncoding, TimestepEmbedder, mlp)
from lsdm_tpu_torch.models.pointnet2 import PointNet2Backbone
from lsdm_tpu_torch.models.posa import POSADecoderBackbone
from lsdm_tpu_torch.ops.attention import TorchMultiheadAttention


class CondCache(NamedTuple):
    """Conditioning features that are constant across sampler steps."""

    enc_text: torch.Tensor  # (B, 1, D)
    out_cat: torch.Tensor  # (B, 1, max_cats) softmax probabilities
    cond_pcd: torch.Tensor  # (B, N, 3): (weighted object features + human) / 2


class SceneDiffusionModel(nn.Module):
    def __init__(self, cfg: SDMConfig):
        super().__init__()
        if cfg.pcd_backbone_type != "PNT2" or cfg.human_backbone_type != "POSA":
            raise NotImplementedError(
                "only the PNT2 object backbone and the POSA human backbone "
                "are ported (DGCNN/STGCN: ROADMAP.md queue 1 item 11)")
        self.cfg = cfg
        D = cfg.latent_dim
        N = cfg.pcd_points
        self.sequence_pos_encoder = PositionalEncoding(D)
        self.embed_timestep = TimestepEmbedder(D)
        self.embed_text = mlp(cfg.clip_dim, (cfg.clip_dim // 2, D * 2, D), "gelu")
        self.embed_cat = mlp(cfg.max_cats, (cfg.cat_emb,), "gelu")
        self.predict_cat = mlp(D, (D // 2, D // 4, cfg.max_cats), "gelu")
        self.attn_layer = TorchMultiheadAttention(
            D, cfg.n_head, kdim=cfg.cat_emb, vdim=N * cfg.pcd_dim)
        self.translation_layer = mlp(D + cfg.cat_emb, (D, cfg.translation_params),
                                     "gelu")
        self.point_wise_trans_layer = mlp(
            cfg.translation_params + cfg.xyz_dim, (cfg.xyz_dim,), "gelu")
        self.pcd_attention = TorchMultiheadAttention(
            cfg.translation_params, cfg.translation_params,
            kdim=cfg.xyz_dim, vdim=cfg.xyz_dim)
        self.pcd_backbone = PointNet2Backbone(
            out_dim=cfg.pcd_dim,
            sa_npoints=(N, max(N // 4, 4), max(N // 16, 2), max(N // 64, 1)),
            sa_nsample=min(32, N), fps_mode=cfg.fps_mode,
            ball_impl=cfg.ball_impl)
        self.human_backbone = POSADecoderBackbone(cfg.vert_dims, N)
        self.upsampling_layer = mlp(1, (128, 512, N), "gelu")
        self.combine_extraction = mlp(2 * D, (D,), "gelu")
        self.input_process = InputProcess(cfg.xyz_dim, D)
        self.output_process = OutputProcess(cfg.xyz_dim, D, N)

    # ------------------------------------------------------------------
    def encode_conditioning(
        self,
        mask: torch.Tensor,  # (B, max_objs) float 0/1, slot 0 = human (0)
        given_objs: torch.Tensor,  # (B, max_objs, N, 3), slot 0 = human
        given_cats: torch.Tensor,  # (B, max_objs, max_cats) one-hot
        text_emb: torch.Tensor,  # (B, clip_dim) frozen text features
        dropout_mask: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> CondCache:
        """Reference ``model/sdm.py`` :145-161 (text/category embeddings,
        category head) and :169-204 (backbones, attentions, translation).
        ``dropout_mask`` / ``generator``: the backbone head's dropout in
        training (``PointNet2Backbone.forward``)."""
        cfg = self.cfg
        B, num_obj, num_points, xyz = given_objs.shape
        D = cfg.latent_dim

        # float32 text features, as JAX casts them, in the weights' dtype
        w = self.embed_text[0].weight
        enc_text = self.embed_text(text_emb.float().to(w.dtype))[:, None, :]  # (B, 1, D)
        # the category head on detached text features (reference :157)
        out_cat = torch.softmax(self.predict_cat(enc_text.detach()), dim=2)
        emb_cat = self.embed_cat(given_cats)  # (B, num_obj, cat_emb)

        hm_out = self.human_backbone(given_objs[:, 0])  # (B, N, 3)
        objs_flat = given_objs.reshape(B * num_obj, num_points, xyz).contiguous()
        pcd_out = self.pcd_backbone(objs_flat, dropout_mask, generator)
        pcd_out = pcd_out.reshape(B, num_obj, num_points * cfg.pcd_dim)

        # text x category x cloud attention with the additive float mask
        attn_mask = mask[:, None, :].float().repeat(cfg.n_head, 1, 1)
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
        pcd_out = pcd_out.transpose(1, 2) * attn_w  # (B, N*pcd_dim, num_obj)
        pcd_out = pcd_out.reshape(B, num_obj, num_points, cfg.pcd_dim)
        pcd_trans = pcd_out.reshape(B * num_obj, cfg.pcd_points, cfg.xyz_dim)
        # head_dim 1: with ball_impl "fused" the K4 kernel in eval, with
        # attn_impl "pallas" the K4/K5 pair in training
        pcd_trans, _ = self.pcd_attention(
            translation, pcd_trans, pcd_trans, need_weights=False,
            fused=(cfg.ball_impl == "fused" and not self.training),
            fused_train=(cfg.attn_impl == "pallas" and self.training))
        pcd_trans = pcd_trans.reshape(B, num_obj, num_points,
                                      cfg.translation_params)
        pcd_out = self.point_wise_trans_layer(
            torch.cat([pcd_out, pcd_trans], dim=-1))  # (B, num_obj, N, 3)
        pcd_out = pcd_out.reshape(num_points, -1, B, num_obj) * mask.float()
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
        """x_t-dependent core (reference :204-212)."""
        return self.output_process(self.input_process(x + cond.cond_pcd, emb))

    def guiding_from_emb(self, cond: CondCache, emb: torch.Tensor
                         ) -> torch.Tensor:
        """Guiding points (reference :213-217), x_t-independent."""
        return self.output_process(self.input_process(cond.cond_pcd, emb))

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
                generator: Optional[torch.Generator] = None
                ) -> DenoiserOutput:
        cond = self.encode_conditioning(mask, given_objs, given_cats, text_emb,
                                        dropout_mask, generator)
        return self.denoise_from_cond(cond, x, timesteps)
