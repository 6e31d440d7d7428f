"""BridgeModel: ContactFormer -> ATISS glue for the "cf_atiss" baseline
(reference ``contact_former/bridge_model.py:9-150``).

Counterpart of ``lsdm_tpu/models/bridge.py``.  Per batch: draw z ~ N(0, 1),
decode contact labels with the frozen POSA decoder on 655 randomly chosen
human points, map the 8-class contact prediction to dataset categories,
vote a category (the *second* most common: the most common is
background, reference ``:54``), take a translation from the voted
points' centroid, then drive the ATISS model with the given objects'
bounding boxes.

The host draws come from ``np.random.RandomState(seed)``, as the JAX
module's, so both give the same boxes from the same seed.  ``posa_decode``
is the port's ``POSADecoder`` (or a stand-in), called on ``device``;
``atiss_apply`` is the port's ATISS model (``models/atiss.py``, as
``run/_baseline_common.py:_make_bridge`` builds it), applied to
``make_boxes``'s output without gradients, or any callable on those
boxes.
"""

from __future__ import annotations

from collections import Counter
from typing import Callable, Dict, Optional

import numpy as np
import torch

from lsdm_tpu_torch.config import HUMANISE_CATEGORIES, PROXD_CATEGORIES
from lsdm_tpu_torch.ops.geometry import translate_objs_to_bbox

# contact-class index -> mpcat40-ish name (reference ``:90-100``)
PRED_SUBSET_TO_NAME = {
    0: "void", 1: "wall", 2: "floor", 3: "chair", 4: "sofa", 5: "table",
    6: "bed", 7: "stool",
}


def contact_class_to_category(idx: int, datatype: str) -> int:
    """(reference ``_lookup_table``, ``bridge_model.py:139-150``)"""
    table = PROXD_CATEGORIES if datatype == "proxd" else HUMANISE_CATEGORIES
    name = PRED_SUBSET_TO_NAME[int(idx)]
    return table.get(name, -1)


class BridgeModel:
    """Callable wrapper pairing a frozen ContactFormer POSA decoder with an
    ATISS model (None where only ``make_boxes`` is used, as in training)."""

    def __init__(
        self,
        atiss_apply: Optional[Callable[[Dict[str, torch.Tensor]], object]],
        posa_decode: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
        datatype: str,
        num_classes: int,
        seed: int = 0,
        device: Optional[torch.device] = None,
    ):
        self.atiss_apply = atiss_apply
        self.posa_decode = posa_decode  # (z (B, 256), verts (B, 655, 3)) -> logits
        self.datatype = datatype
        self.num_classes = num_classes
        self.device = torch.device(device or "cpu")
        self._rng = np.random.RandomState(seed)

    def __call__(self, given_objs: np.ndarray, given_cats: np.ndarray,
                 mask: np.ndarray):
        """given_objs (B, O, N, 3), given_cats (B, O, C), mask (B, O)
        -> the ATISS model's prediction."""
        boxes = self.make_boxes(given_objs, given_cats, mask)
        with torch.no_grad():
            return self.atiss_apply(boxes)

    @torch.no_grad()
    def make_boxes(self, given_objs: np.ndarray, given_cats: np.ndarray,
                   mask: np.ndarray) -> Dict[str, torch.Tensor]:
        """The frozen-ContactFormer half of the bridge as host preprocessing:
        contact sampling + category vote + slot-0 bbox override.  Training
        the bridge is training ATISS on these boxes (CF frozen, reference
        ``bridge_model.py:18-20``)."""
        B = given_objs.shape[0]
        human = np.asarray(given_objs[:, 0])  # (B, N, 3)
        chosen = self._rng.randint(0, human.shape[1], size=655)
        human_655 = human[:, chosen]  # (B, 655, 3)

        z = self._rng.normal(0, 1, (B, 256)).astype(np.float32)
        logits = self.posa_decode(torch.from_numpy(z).to(self.device),
                                  torch.from_numpy(np.ascontiguousarray(
                                      human_655, np.float32)).to(self.device))
        contact = logits.argmax(-1).cpu().numpy()  # (B, 655)

        # per-batch category vote + translation (reference :37-58)
        default_tr, default_sz = translate_objs_to_bbox(human_655)
        translations0 = np.zeros((B, 3), np.float32)
        sizes0 = default_sz
        for b in range(B):
            cats = [contact_class_to_category(c, self.datatype) for c in contact[b]]
            counter = Counter(cats)
            if len(counter) == 1:
                translations0[b] = default_tr[b]
            else:
                cat = counter.most_common()[1][0]
                sel = np.asarray(cats) == cat
                translations0[b] = human_655[b][sel].mean(0)

        # number of given objects (reference :60-65: first zero-mask slot)
        num_obj = mask.shape[1]
        for idx in range(1, mask.shape[1]):
            if mask[0][idx] == 0:
                num_obj = idx
                break

        flat = np.asarray(given_objs[:, :num_obj]).reshape(-1, given_objs.shape[2], 3)
        translations, sizes = translate_objs_to_bbox(flat)
        translations = translations.reshape(B, num_obj, 3)
        sizes = sizes.reshape(B, num_obj, 3)
        translations[:, 0] = translations0
        sizes[:, 0] = sizes0

        cats = np.asarray(given_cats[:, :num_obj])
        if cats.shape[-1] < self.num_classes:
            pad = np.zeros((B, num_obj, self.num_classes - cats.shape[-1]),
                           np.float32)
            cats = np.concatenate([cats, pad], axis=-1)

        def put(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

        def ones(*shape):
            return torch.ones(shape, device=self.device)

        return {
            "class_labels": put(cats),
            "translations": put(translations),
            "sizes": put(sizes),
            "angles": torch.zeros((B, num_obj, 1), device=self.device),
            "room_layout": ones(B, 1, 64, 64),
            "class_labels_tr": ones(B, 1, self.num_classes),
            "translations_tr": ones(B, 1, 3),
            "sizes_tr": ones(B, 1, 3),
            "angles_tr": ones(B, 1, 1),
        }
