"""ContactFormer: a per-frame POSA VAE and a temporal decoder over a
motion sequence (reference ``contact_former/contact_former.py:18-196``).

Counterpart of ``lsdm_tpu/models/contactformer.py``.  It predicts each
vertex's contact-semantic class (8 classes) in every frame of a 655-vertex
body sequence.  Five decoder modes, as the reference's:

  0 — POSA only (per frame, no temporal context)
  1 — encoder-decoder transformer (``TransformerDecoder``)
  2 — transformer encoder only (``TransformerDecoder2``)
  3 — frame-wise MLP (``MLPDecoder3``)
  4 — bidirectional LSTM (``LSTMDecoder4``)

The temporal axis is the frame axis (``seg_len`` up to 256): each frame's
(655 x 8) POSA logits become one ``d_hid`` vector, the temporal model runs
over the frames, and its output, broadcast back onto the vertices beside
the POSA logits, goes through a small MLP head.

The JAX module calls its transformer layers without ``train``, so no
dropout runs, in training either; none is here.  The key-padding mask is
an additive -1e9 bias, not a boolean mask.  Mode 4 is one
``nn.LSTM(bidirectional=True)``: flax's two ``nn.RNN(OptimizedLSTMCell)``
run the whole padded sequence forward and backward with no sequence
lengths, as torch's directions do; flax has no input bias, so
``bias_ih`` is zero and takes no gradient (``weights.py`` carries flax's
hidden bias into ``bias_hh``).  cuDNN runs that LSTM in TF32 unless
told otherwise; ``models/cudnn.py:cudnn_full_fp32`` turns it off around the forward here
and around the backward in ``train/contact.py``, since cuDNN reads the
setting again when it builds the backward.  Parameter names are the JAX
modules'.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from lsdm_tpu_torch.models.atiss import TorchTransformerEncoderLayer
from lsdm_tpu_torch.models.cudnn import cudnn_full_fp32
from lsdm_tpu_torch.models.posa import POSA
from lsdm_tpu_torch.ops.attention import Linear, multihead_attention
from lsdm_tpu_torch.ops.embeddings import positional_encoding_table


class TorchTransformerDecoderLayer(nn.Module):
    """``torch.nn.TransformerDecoderLayer`` parity (post-LN, ReLU):
    self-attention, cross-attention, FFN."""

    def __init__(self, d_model: int, n_heads: int, dim_ff: int):
        super().__init__()
        self.n_heads = n_heads
        E = d_model
        for name in ("self", "cross"):
            w = nn.Parameter(torch.empty(3 * E, E))
            nn.init.xavier_uniform_(w)
            setattr(self, f"{name}_in_proj_weight", w)
            setattr(self, f"{name}_in_proj_bias", nn.Parameter(torch.zeros(3 * E)))
            setattr(self, f"{name}_out_proj", Linear(E, E))
        self.norm1 = nn.LayerNorm(E, eps=1e-5)
        self.norm2 = nn.LayerNorm(E, eps=1e-5)
        self.norm3 = nn.LayerNorm(E, eps=1e-5)
        self.linear1 = Linear(E, dim_ff)
        self.linear2 = Linear(dim_ff, E)

    def _mha(self, name: str, q_in, kv_in, mask):
        w = getattr(self, f"{name}_in_proj_weight")
        b = getattr(self, f"{name}_in_proj_bias")
        E = w.shape[1]
        q = F.linear(q_in, w[:E], b[:E])
        k = F.linear(kv_in, w[E:2 * E], b[E:2 * E])
        v = F.linear(kv_in, w[2 * E:], b[2 * E:])
        out, _ = multihead_attention(q, k, v, self.n_heads, attn_mask=mask,
                                     need_weights=False)
        return getattr(self, f"{name}_out_proj")(out)

    def forward(self, tgt, memory, tgt_mask=None, mem_mask=None):
        x = self.norm1(tgt + self._mha("self", tgt, tgt, tgt_mask))
        x = self.norm2(x + self._mha("cross", x, memory, mem_mask))
        h = self.linear2(F.relu(self.linear1(x)))
        return self.norm3(x + h)


def _padding_bias(mask: torch.Tensor) -> torch.Tensor:
    """Key-padding mask (B, S) of 0/1 valid -> additive (B, 1, S) bias."""
    zero = torch.zeros((), dtype=torch.float32, device=mask.device)
    return torch.where(mask > 0, zero, zero - 1e9)[:, None, :]


class _OutHead(nn.Sequential):
    """cat(posa_logits, temporal feature) -> contact logits (the shared
    ``out_linear`` stack, reference :71-75); children ``0`` and ``2`` as
    the JAX module's."""

    def __init__(self, d_hid: int, no_obj_classes: int = 8):
        super().__init__(Linear(no_obj_classes + d_hid, d_hid // 2), nn.ReLU(),
                         Linear(d_hid // 2, no_obj_classes))


class ContactFormer(nn.Module):
    """(reference ``ContactFormer``, ``contact_former.py:18-56``)

    ``forward(cf, vertices, mask, eps=None, generator=None)``:
      cf:       (T, 655, 8) contact one-hots (the VAE's input)
      vertices: (T, 655, 3)
      mask:     (1, >= T) frame validity
      eps:      (T, z) reparameterisation noise (else drawn from
                ``generator`` on the device)
      -> (contact logits (1, T, 655, 8), mu (1, T, z), logvar (1, T, z))

    ``spiral_indices`` and ``down_mats`` are ``data/mesh_assets.py``'s; the
    mesh levels follow the down matrices' shapes.
    """

    def __init__(self, spiral_indices: Sequence[np.ndarray],
                 down_mats: Sequence[torch.Tensor], seg_len: int = 256,
                 decoder_mode: int = 1, n_layer: int = 6, n_head: int = 8,
                 dim_ff: int = 512, d_hid: int = 512, no_obj_classes: int = 8):
        super().__init__()
        if decoder_mode not in range(5):
            raise NotImplementedError(decoder_mode)
        self.decoder_mode = decoder_mode
        D = d_hid
        nv = down_mats[0].shape[1]
        self.posa = POSA(spiral_indices, down_mats, no_obj_classes)
        if decoder_mode == 0:  # POSA alone, as the JAX module's parameters
            return
        self.frame_emb_linear = Linear(nv * no_obj_classes, D)
        self.out_head = _OutHead(D, no_obj_classes)
        self.register_buffer(
            "pe", torch.from_numpy(positional_encoding_table(D, seg_len)),
            persistent=False)
        if decoder_mode in (1, 2):
            for i in range(n_layer):
                setattr(self, f"enc_{i}",
                        TorchTransformerEncoderLayer(D, n_head, dim_ff))
        if decoder_mode == 1:
            for i in range(n_layer):
                setattr(self, f"dec_{i}",
                        TorchTransformerDecoderLayer(D, n_head, dim_ff))
        self.n_layer = n_layer
        if decoder_mode == 3:
            self.mlp_block_0 = Linear(D, D * 2)
            self.mlp_block_2 = Linear(D * 2, D)
        if decoder_mode == 4:
            self.lstm = nn.LSTM(D, dim_ff, batch_first=True, bidirectional=True)
            for name, p in self.lstm.named_parameters():
                if name.startswith("bias_ih"):  # flax's cell has no input bias
                    nn.init.zeros_(p)
                    p.requires_grad_(False)
            self.bidir = Linear(2 * dim_ff, D)

    def _frame_embed(self, posa_out: torch.Tensor) -> torch.Tensor:
        T = posa_out.shape[0]
        x = F.relu(self.frame_emb_linear(posa_out.reshape(T, -1)))
        return x + self.pe[:T]  # (T, d_hid)

    def _temporal(self, posa_out: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """(T, 655, 8), (1, >= T) -> temporal features (T, d_hid)."""
        T = posa_out.shape[0]
        h = self._frame_embed(posa_out)[None]  # (1, T, D)
        if self.decoder_mode in (1, 2):
            # key padding as an additive bias over the keys, the torch
            # src_key_padding_mask semantics
            bias = _padding_bias(mask[:, :T]).expand(1, T, T)[0]
            x = h
            for i in range(self.n_layer):
                x = getattr(self, f"enc_{i}")(x, attn_bias=bias)
            if self.decoder_mode == 2:
                return x[0]
            y = h
            for i in range(self.n_layer):
                y = getattr(self, f"dec_{i}")(y, x, tgt_mask=bias, mem_mask=bias)
            return y[0]
        if self.decoder_mode == 3:
            return F.relu(self.mlp_block_2(F.relu(self.mlp_block_0(h[0]))))
        x = h * (mask[:, :T] > 0)[..., None].to(h.dtype)  # mode 4
        with cudnn_full_fp32():
            out, _ = self.lstm(x)
        return F.relu(self.bidir(out[0]))

    def forward(self, cf: torch.Tensor, vertices: torch.Tensor,
                mask: torch.Tensor, eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        posa_out, mu, logvar = self.posa(cf, vertices, eps, generator)
        if self.decoder_mode == 0:
            return posa_out[None], mu[None], logvar[None]
        temporal = self._temporal(posa_out, mask)  # (T, d_hid)
        T, V, _ = posa_out.shape
        tfeat = temporal[:, None, :].expand(T, V, temporal.shape[-1])
        out = self.out_head(torch.cat([posa_out, tfeat], dim=-1))
        return out[None], mu[None], logvar[None]
