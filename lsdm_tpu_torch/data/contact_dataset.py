"""Contact-semantics datasets for POSA / ContactFormer training
(reference ``posa/dataset.py``).

A copy of ``lsdm_tpu/data/contact_dataset.py``, which imports the JAX
package (its ``.npy`` reader and ``ops/geometry.py``) and calls ``jnp``:
here the arrays are read with ``np.load`` and the orientation fix is the
port's ``ops/geometry.py:normalize_orientation`` on a CPU tensor.  The
``np.random.RandomState`` draws are the JAX module's, call for call, so
both packages give the same samples from the same seed.

Disk layout (shared by all variants):
  <data_dir>/vertices_can/<seq>verts_can.npy   (T, 655, 3) canonical verts
  <data_dir>/vertices/<seq>verts.npy           (T, 655, 3) world verts
  <data_dir>/semantics/<seq>cfs.npy            (T, 655) int contact classes

Variants:
  * :class:`ProxContactDataset` — the final ContactFormer loader
    (``ProxDataset_ds``, ``posa/dataset.py:268-346``): one jump-stepped
    window zero-padded to ``max_frame`` + mask.
  * :class:`ProxSegDataset` — fixed-length random segments
    (``posa/dataset.py:12-68``), the original POSA trainer's loader.
  * :class:`ProxSegDatasetSeq` — ``num_seg`` strided consecutive segments
    stacked (``posa/dataset.py:74-146``), legacy ContactFormer.
  * :class:`ProxSegDatasetVar` — variable-length segments cut where the
    body's xy centroid has moved > ``dist_eps``, padded to ``max_frame``
    with masks (``posa/dataset.py:148-266``), legacy ContactFormer.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from lsdm_tpu_torch.ops.geometry import normalize_orientation


def _normalize(vc: np.ndarray, associated_joints: np.ndarray) -> np.ndarray:
    return normalize_orientation(torch.from_numpy(np.ascontiguousarray(vc)),
                                 associated_joints).numpy()


class ProxContactDataset:
    def __init__(
        self,
        data_dir: str,
        fix_orientation: bool = False,
        no_obj_classes: int = 8,
        max_frame: int = 220,
        jump_step: int = 8,
        step_multiplier: int = 1,
        ds_weights_path: Optional[str] = None,
        seed: int = 0,
        **_,
    ):
        self.data_dir = data_dir
        self.contacts_dir = os.path.join(data_dir, "semantics")
        self.verts_can_dir = os.path.join(data_dir, "vertices_can")
        self.verts_dir = os.path.join(data_dir, "vertices")
        self.seq_names = sorted(
            f.split("cfs")[0] for f in os.listdir(self.contacts_dir)
        )
        self.no_obj_classes = no_obj_classes
        self.max_frame = max_frame
        self.jump_step = jump_step
        self.step_multiplier = step_multiplier
        self.fix_orientation = fix_orientation
        self._rng = np.random.RandomState(seed)

        self.verts_can = {}
        self.contacts = {}
        self.total_frames = 0
        for seq in self.seq_names:
            self.verts_can[seq] = np.load(
                os.path.join(self.verts_can_dir, seq + "verts_can.npy")
            ).astype(np.float32)
            self.contacts[seq] = np.load(
                os.path.join(self.contacts_dir, seq + "cfs.npy")
            ).astype(np.int32)
            self.total_frames += self.verts_can[seq].shape[0]

        self.associated_joints = None
        if fix_orientation and ds_weights_path and os.path.exists(ds_weights_path):
            w = np.load(ds_weights_path)
            self.associated_joints = np.argmax(w, axis=1)

    def __len__(self) -> int:
        return max(self.step_multiplier * self.total_frames // self.max_frame, 1)

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        seq = self.seq_names[self._rng.randint(len(self.seq_names))]
        verts_can = self.verts_can[seq]
        contacts = self.contacts[seq]
        T = verts_can.shape[0]

        if self.max_frame * self.jump_step > T:
            start = self._rng.randint(self.jump_step)
            end = T
        else:
            start = self._rng.randint(T - self.max_frame * self.jump_step)
            end = start + self.max_frame * self.jump_step

        vc = verts_can[start : end : self.jump_step]
        if self.fix_orientation and self.associated_joints is not None:
            vc = _normalize(vc, self.associated_joints)
        cs = contacts[start : end : self.jump_step]
        onehot = np.eye(self.no_obj_classes, dtype=np.float32)[
            np.clip(cs, 0, self.no_obj_classes - 1)
        ]

        seg = vc.shape[0]
        mask = np.zeros(self.max_frame, np.float32)
        mask[:seg] = 1
        vc_pad = np.zeros((self.max_frame, *vc.shape[1:]), np.float32)
        vc_pad[:seg] = vc
        cs_pad = np.zeros((self.max_frame, *onehot.shape[1:]), np.float32)
        cs_pad[:seg] = onehot
        return vc_pad, cs_pad, mask


class _SegBase:
    """Shared loading/orientation machinery of the legacy seg datasets."""

    def __init__(self, data_dir, fix_orientation, no_obj_classes,
                 ds_weights_path, seed, load_world_verts=False):
        self.data_dir = data_dir
        self.contacts_dir = os.path.join(data_dir, "semantics")
        self.verts_can_dir = os.path.join(data_dir, "vertices_can")
        self.verts_dir = os.path.join(data_dir, "vertices")
        self.seq_names = sorted(
            f.split("cfs")[0] for f in os.listdir(self.contacts_dir)
        )
        self.no_obj_classes = no_obj_classes
        self.fix_orientation = fix_orientation
        self._rng = np.random.RandomState(seed)

        self.verts_can = {}
        self.verts = {}
        self.contacts = {}
        self.total_frames = 0
        for seq in self.seq_names:
            self.verts_can[seq] = np.load(
                os.path.join(self.verts_can_dir, seq + "verts_can.npy")
            ).astype(np.float32)
            self.contacts[seq] = np.load(
                os.path.join(self.contacts_dir, seq + "cfs.npy")
            ).astype(np.int32)
            if load_world_verts:
                self.verts[seq] = np.load(
                    os.path.join(self.verts_dir, seq + "verts.npy")
                ).astype(np.float32)
            self.total_frames += self.verts_can[seq].shape[0]

        self.associated_joints = None
        if fix_orientation and ds_weights_path and os.path.exists(ds_weights_path):
            w = np.load(ds_weights_path)
            self.associated_joints = np.argmax(w, axis=1)

    def _onehot(self, cs: np.ndarray) -> np.ndarray:
        return np.eye(self.no_obj_classes, dtype=np.float32)[
            np.clip(cs, 0, self.no_obj_classes - 1)
        ]

    def _orient(self, vc: np.ndarray) -> np.ndarray:
        if self.fix_orientation and self.associated_joints is not None:
            vc = _normalize(vc, self.associated_joints)
        return vc


class ProxSegDataset(_SegBase):
    """Fixed-length random motion segments (reference ``posa/dataset.py:12-68``):
    returns ``(verts_can (L, V, 3), contacts one-hot (L, V, C))``."""

    def __init__(self, data_dir, fix_orientation=False, no_obj_classes=8,
                 train_seg_len=32, jump_step=1, step_multiplier=1,
                 ds_weights_path=None, seed=0, **_):
        super().__init__(data_dir, fix_orientation, no_obj_classes,
                         ds_weights_path, seed)
        self.train_seg_len = train_seg_len
        self.jump_step = jump_step
        self.step_multiplier = step_multiplier

    def __len__(self):
        return max(self.step_multiplier * self.total_frames
                   // self.train_seg_len, 1)

    def __getitem__(self, idx):
        seq = self.seq_names[self._rng.randint(len(self.seq_names))]
        vc_all, cs_all = self.verts_can[seq], self.contacts[seq]
        span = self.train_seg_len * self.jump_step
        start = self._rng.randint(max(vc_all.shape[0] - 1 - span, 1))
        vc = self._orient(vc_all[start : start + span : self.jump_step])
        return vc, self._onehot(cs_all[start : start + span : self.jump_step])


class ProxSegDatasetSeq(_SegBase):
    """``num_seg`` consecutive strided segments (reference
    ``posa/dataset.py:74-146``): returns ``(verts_can (S, L, V, 3),
    contacts (S, L, V, C))``; sequences too short for the full window are
    rejected and resampled like the reference's while-loop."""

    def __init__(self, data_dir, fix_orientation=False, no_obj_classes=8,
                 train_seg_len=32, num_seg=8, stride=32, jump_step=1,
                 step_multiplier=1, ds_weights_path=None, seed=0, **_):
        super().__init__(data_dir, fix_orientation, no_obj_classes,
                         ds_weights_path, seed)
        self.train_seg_len = train_seg_len
        self.num_seg = num_seg
        self.stride = stride
        self.jump_step = jump_step
        self.step_multiplier = step_multiplier

    def __len__(self):
        return max(self.step_multiplier * self.total_frames
                   // (self.train_seg_len * self.num_seg), 1)

    def __getitem__(self, idx):
        window = (self.train_seg_len
                  + (self.num_seg - 1) * self.stride) * self.jump_step
        candidates = [s for s in self.seq_names
                      if self.verts_can[s].shape[0] - 1 - window > 0]
        if not candidates:
            raise ValueError(
                f"no sequence long enough for {self.num_seg} segments "
                f"({window} frames)")
        seq = candidates[self._rng.randint(len(candidates))]
        vc_all, cs_all = self.verts_can[seq], self.contacts[seq]
        start = self._rng.randint(vc_all.shape[0] - 1 - window)
        end = start + self.train_seg_len * self.jump_step
        vcs, css = [], []
        for _ in range(self.num_seg):
            vcs.append(self._orient(vc_all[start:end : self.jump_step]))
            css.append(self._onehot(cs_all[start:end : self.jump_step]))
            start += self.stride * self.jump_step
            end += self.stride * self.jump_step
        return np.stack(vcs), np.stack(css)


class ProxSegDatasetVar(_SegBase):
    """Variable-length motion segments (reference ``posa/dataset.py:148-266``):
    each of ``num_seg`` segments runs until the body's xy centroid drifts
    more than ``dist_eps`` from the segment start, truncated/zero-padded to
    ``max_frame``.  Returns ``(verts_can (S, F, V, 3), contacts (S, F, V, C),
    masks (S, F))``.

    Deviation from the reference: ``posa/dataset.py:223`` subtracts
    ``cur_center`` from an aliased strided *view* of ``verts_center``
    in place (undefined-order aliasing in torch); we compute distances on a
    copy, which matches the obviously-intended semantics.
    """

    def __init__(self, data_dir, fix_orientation=False, no_obj_classes=8,
                 max_frame=128, num_seg=10, dist_eps=0.7, jump_step=8,
                 step_multiplier=1, ds_weights_path=None, seed=0, **_):
        super().__init__(data_dir, fix_orientation, no_obj_classes,
                         ds_weights_path, seed, load_world_verts=True)
        self.max_frame = max_frame
        self.num_seg = num_seg
        self.dist_eps = dist_eps
        self.jump_step = jump_step
        self.step_multiplier = step_multiplier

    def __len__(self):
        return max(self.step_multiplier * self.total_frames
                   // (self.max_frame * self.num_seg), 1)

    def __getitem__(self, idx):
        seq = self.seq_names[self._rng.randint(len(self.seq_names))]
        vc_all, cs_all = self.verts_can[seq], self.contacts[seq]
        verts = self.verts[seq]
        T, V = vc_all.shape[0], vc_all.shape[1]
        verts_center = verts[:, :, :2].mean(axis=1)  # (T, 2)

        def empty():
            return (np.zeros((self.max_frame, V, 3), np.float32),
                    np.zeros((self.max_frame, V, self.no_obj_classes),
                             np.float32),
                    np.zeros(self.max_frame, np.float32))

        vcs, css, masks = [], [], []
        start = int(self._rng.randint(max(T // 2, 1)))
        for _ in range(self.num_seg):
            if start >= T:
                v, c, m = empty()
                vcs.append(v); css.append(c); masks.append(m)
                continue
            rem = verts_center[start :: self.jump_step] - verts_center[start]
            far = (np.linalg.norm(rem, axis=1) > self.dist_eps).astype(np.int32)
            if rem.shape[0] == 0 or far.sum() == 0:
                v, c, m = empty()
                vcs.append(v); css.append(c); masks.append(m)
                continue
            end = start + int(np.argmax(far)) * self.jump_step
            vc = vc_all[start:end : self.jump_step]
            cs = cs_all[start:end : self.jump_step]
            seg = min(vc.shape[0], self.max_frame)
            vc, cs = vc[:seg], cs[:seg]
            vc = self._orient(vc)
            v, c, m = empty()
            v[:seg], c[:seg], m[:seg] = vc, self._onehot(cs), 1.0
            vcs.append(v); css.append(c); masks.append(m)
            start += seg * self.jump_step

        return np.stack(vcs), np.stack(css), np.stack(masks)
