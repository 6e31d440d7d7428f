"""Next-object class and translation inside a box (reference
``get_next_obj_class.py:12-57``).

Counterpart of ``lsdm_tpu/fitting/next_obj_class.py``: the class is drawn
from ATISS's ``distribution_classes`` as ``jax.random.choice(p=...)``
draws it (a uniform u, the first cumulative probability >= total * (1 -
u)); the translation is drawn from the DMLL heads again until it lands
inside the box, the box's centre after ``max_tries`` misses.  Needs the
DMLL-parameterised head (``scalar_head=False``); a scalar head has no
distribution to draw from.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from lsdm_tpu_torch.models.atiss import DrawSource, as_draws


@torch.no_grad()
def sample_in_bbox(model, boxes: Dict[str, torch.Tensor], bbox_min: np.ndarray,
                   bbox_max: np.ndarray, draws: DrawSource = None,
                   max_tries: int = 100) -> Tuple[int, np.ndarray]:
    """(class index, translation (3,)) with the translation redrawn until it
    lies in [bbox_min, bbox_max].  Draws: the class's uniform, then each
    try's translation draws."""
    d = as_draws(draws)
    probs = model.distribution_classes(boxes)[0, 0].cpu().numpy()
    probs = probs / probs.sum()
    p = torch.from_numpy(probs).to(boxes["class_labels"].device)
    cum = torch.cumsum(p, 0)
    r = cum[-1] * (1 - d.uniform((), p))
    cls = int(torch.searchsorted(cum, r))
    onehot = F.one_hot(torch.tensor([[cls]], device=p.device), len(probs)).to(p.dtype)
    feat = model.encode(boxes)
    for _ in range(max_tries):
        tr = model.hidden2output.sample_translations(feat, onehot, d)[0, 0].cpu().numpy()
        if (tr >= bbox_min).all() and (tr <= bbox_max).all():
            return cls, tr
    return cls, (np.asarray(bbox_min) + np.asarray(bbox_max)) / 2
