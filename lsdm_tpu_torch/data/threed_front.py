"""3D-FRONT / 3D-FUTURE data stack (slimmed, functional).

A copy of ``lsdm_tpu/data/threed_front.py`` (host numpy; the port imports
nothing of the JAX package), reading meshes with the port's
``ops/spiral.py:load_obj``.

Covers what the pipeline actually consumes from the reference's vendored
NVIDIA stack (``atiss/scene_synthesis/datasets/``, ~2,200 LoC):

  * :class:`FurnitureModel` / :class:`ThreedFutureDataset` — the CAD
    library with size-matched retrieval
    (``threed_future_dataset.py:15-67``; used by ``get_next_obj_class.py:9``
    and the fitting/scene-completion stages);
  * :class:`CachedThreedFront` — autoregressive training samples from
    per-scene box caches (class_labels/translations/sizes/angles +
    room-layout mask), the "cached_autoregressive" encoding family
    (``threed_front_dataset.py``): a random permutation of the scene's
    boxes, a random split point, boxes before the split as context and the
    split box as the *_tr target;
  * :func:`build_splits` — csv-driven train/val/test splits
    (``splits_builder.py``).

The heavyweight raw-3D-FRONT parsing (texture/json scene ingestion) is an
offline preprocessing concern; this module consumes the standard cached
format (one ``boxes.npz`` per room).
"""

from __future__ import annotations

import csv
import json
import os
import pickle
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from lsdm_tpu_torch.ops.spiral import load_obj


class FurnitureModel(NamedTuple):
    model_jid: str
    label: str
    size: np.ndarray  # (3,) half extents or extents, dataset convention
    path: str  # raw_model.obj location ("" if unknown)

    def raw_model_path(self) -> str:
        return self.path


class ThreedFutureDataset:
    """(reference ``threed_future_dataset.py:15-67``)"""

    def __init__(self, objects: Sequence[FurnitureModel]):
        assert len(objects) > 0
        self.objects = list(objects)

    def __len__(self):
        return len(self.objects)

    def __getitem__(self, idx):
        return self.objects[idx]

    def _filter_objects_by_label(self, label: str):
        return [o for o in self.objects if o.label == label]

    def get_closest_furniture_to_box(self, query_label: str, query_size):
        objects = self._filter_objects_by_label(query_label)
        if not objects:
            return None
        mses = [float(np.sum((o.size - np.asarray(query_size)) ** 2)) for o in objects]
        return objects[int(np.argmin(mses))]

    def get_closest_furniture_to_2dbox(self, query_label: str, query_size):
        objects = self._filter_objects_by_label(query_label)
        if not objects:
            return None
        mses = [
            (o.size[0] - query_size[0]) ** 2 + (o.size[2] - query_size[1]) ** 2
            for o in objects
        ]
        return objects[int(np.argmin(mses))]

    @classmethod
    def from_pickled_dataset(cls, path: str) -> "ThreedFutureDataset":
        with open(path, "rb") as f:
            return pickle.load(f)

    @classmethod
    def from_directory(cls, root: str) -> "ThreedFutureDataset":
        """Build from a ``<root>/<label>/<id>/raw_model.obj`` (or
        ``<root>/<label>/<id>.obj``) tree; sizes from mesh bboxes."""
        objects = []
        for label in sorted(os.listdir(root)):
            label_dir = os.path.join(root, label)
            if not os.path.isdir(label_dir):
                continue
            for entry in sorted(os.listdir(label_dir)):
                p = os.path.join(label_dir, entry)
                if os.path.isdir(p):
                    mesh = os.path.join(p, "raw_model.obj")
                    jid = entry
                elif entry.endswith(".obj"):
                    mesh = p
                    jid = entry[:-4]
                else:
                    continue
                if not os.path.exists(mesh):
                    continue
                verts, _ = load_obj(mesh)
                size = ((verts.max(0) - verts.min(0)) / 2).astype(np.float32)
                objects.append(FurnitureModel(jid, label, size, mesh))
        return cls(objects)


def build_splits(annotation_csv: str) -> Dict[str, List[str]]:
    """scene-id -> split csv (reference ``splits_builder.py``):
    rows of (scene_id, split)."""
    splits: Dict[str, List[str]] = {}
    with open(annotation_csv) as f:
        for row in csv.reader(f):
            if len(row) < 2:
                continue
            splits.setdefault(row[-1].strip(), []).append(row[0].strip())
    return splits


class CachedThreedFront:
    """Autoregressive training samples from cached rooms.

    Directory layout: ``<root>/<scene_id>/boxes.npz`` with arrays
    ``class_labels (L, C)``, ``translations (L, 3)``, ``sizes (L, 3)``,
    ``angles (L, 1)`` and optional ``room_layout (H, W)``.

    ``__getitem__`` implements the "cached_autoregressive_wocm" recipe:
    permute the boxes, choose a split point m, return the first m boxes as
    context plus box m as the prediction target (*_tr), padded to
    ``max_boxes`` with a validity mask — statically shaped for TPU.
    """

    def __init__(
        self,
        root: str,
        scene_ids: Optional[Sequence[str]] = None,
        max_boxes: int = 12,
        room_layout_size: int = 64,
        seed: int = 0,
    ):
        self.root = root
        self.max_boxes = max_boxes
        self.room_layout_size = room_layout_size
        self._rng = np.random.RandomState(seed)
        all_ids = sorted(
            d for d in os.listdir(root)
            if os.path.exists(os.path.join(root, d, "boxes.npz"))
        )
        self.scene_ids = [s for s in all_ids if scene_ids is None or s in scene_ids]
        assert self.scene_ids, f"no cached rooms under {root}"
        with np.load(os.path.join(root, self.scene_ids[0], "boxes.npz")) as d:
            self.n_classes = d["class_labels"].shape[-1]

    def __len__(self):
        return len(self.scene_ids)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        with np.load(os.path.join(self.root, self.scene_ids[idx], "boxes.npz")) as d:
            cls = d["class_labels"].astype(np.float32)
            tr = d["translations"].astype(np.float32)
            sz = d["sizes"].astype(np.float32)
            ang = d["angles"].astype(np.float32)
            layout = d["room_layout"] if "room_layout" in d else None
        L = len(cls)
        perm = self._rng.permutation(L)
        cls, tr, sz, ang = cls[perm], tr[perm], sz[perm], ang[perm]
        m = self._rng.randint(0, L)  # context length; box m is the target

        C = self.n_classes
        K = self.max_boxes
        out = {
            "class_labels": np.zeros((K, C), np.float32),
            "translations": np.zeros((K, 3), np.float32),
            "sizes": np.zeros((K, 3), np.float32),
            "angles": np.zeros((K, 1), np.float32),
            "valid_mask": np.zeros((K,), np.float32),
        }
        n_ctx = min(m, K)
        out["class_labels"][:n_ctx] = cls[:n_ctx]
        out["translations"][:n_ctx] = tr[:n_ctx]
        out["sizes"][:n_ctx] = sz[:n_ctx]
        out["angles"][:n_ctx] = ang[:n_ctx]
        out["valid_mask"][:n_ctx] = 1
        out["class_labels_tr"] = cls[m : m + 1]
        out["translations_tr"] = tr[m : m + 1]
        out["sizes_tr"] = sz[m : m + 1]
        out["angles_tr"] = ang[m : m + 1]
        if layout is None:
            layout = np.ones((self.room_layout_size, self.room_layout_size),
                             np.float32)
        out["room_layout"] = layout.astype(np.float32)[None]  # (1, H, W)
        return out

    def collate(self, idxs: Sequence[int]) -> Dict[str, np.ndarray]:
        items = [self[i] for i in idxs]
        return {k: np.stack([it[k] for it in items]) for k in items[0]}
