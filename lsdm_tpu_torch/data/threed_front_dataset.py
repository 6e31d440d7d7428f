"""3D-FRONT dataset layer: filters, statistics, encodings.

A copy of ``lsdm_tpu/data/threed_front_dataset.py`` (host numpy; the port
imports nothing of the JAX package) over the port's
``data/threed_front_scene.py``; PIL and scipy stay lazy imports.

From-scratch design of the capability covered by the reference's vendored
NVIDIA dataset plumbing (``atiss/scene_synthesis/datasets/{common,base,
threed_front,threed_front_dataset,splits_builder,__init__}.py``), organized
around three ideas the reference's decorator tower does not have:

  1. **Filters are data.**  The reference writes one near-identical
     filter-chain block per room type (``datasets/__init__.py:78-184``);
     here each room type is a :class:`RoomFilterSpec` row in
     :data:`ROOM_FILTER_SPECS` and one builder (:func:`room_filter`)
     interprets the table.  Individual filters are free functions returning
     ``Room -> Room | None``.
  2. **Statistics are array reductions.**  Dataset bounds / class counts
     come from one concatenated struct-of-arrays pass over
     :func:`~lsdm_tpu_torch.data.threed_front_scene.room_arrays`
     (:meth:`ThreedFront._table`), not per-box min/max accumulator loops
     (cf. ``threed_front.py:75-92``).
  3. **Encodings are pure functions.**  The reference stacks 12 dataset
     decorator classes (``threed_front_dataset.py:18-467``); here each step
     (rotation/jitter augmentation, [-1,1] scaling, permutation,
     autoregressive end-target append, WOCM split) is a sample->sample
     function and :class:`EncodedRooms` folds a pipeline of them over a base
     sample builder.  :func:`dataset_encoding_factory` assembles pipelines
     by encoding name.

Behavioral contracts preserved (cited in place): the encoding order
base -> order -> augment -> scale -> permute -> end-append -> WOCM-split,
the collate padding/"lengths"/singleton-``_tr``-axis shapes, module-level
``np.random`` draws (seed ``np.random.seed`` for reproducible epochs), the
scalar-per-key jitter quirk, and the filter thresholds.

The furniture vocabularies (category -> generic label maps) and the filter
threshold constants are part of the public ATISS/3D-FRONT dataset contract
and are reproduced from the reference's NVIDIA-licensed sources
(``datasets/base.py:9-204``, ``datasets/__init__.py:78-184``) — see
NOTICE at the repo root for attribution.
"""

from __future__ import annotations

import csv
import json
import os
from collections import Counter, OrderedDict
from dataclasses import dataclass
from typing import (Callable, Dict, List, Mapping, NamedTuple, Optional,
                    Sequence, Tuple)

import numpy as np

from lsdm_tpu_torch.data.threed_front_scene import (Room, box_order,
                                              parse_threed_front_scenes,
                                              room_arrays)

Sample = Dict[str, np.ndarray]
Transform = Callable[[Sample], Sample]
RoomFilter = Callable[[Room], Optional[Room]]

#: the per-box sample keys every box-axis operation touches
BOX_KEYS = ("class_labels", "translations", "sizes", "angles")

# ---------------------------------------------------------------------------
# furniture vocabularies (NVIDIA-derived data tables — see NOTICE;
# reference ``datasets/base.py:9-204``)

THREED_FRONT_BEDROOM_FURNITURE = {
    "desk": "desk",
    "nightstand": "nightstand",
    "king-size bed": "double_bed",
    "single bed": "single_bed",
    "kids bed": "kids_bed",
    "ceiling lamp": "ceiling_lamp",
    "pendant lamp": "pendant_lamp",
    "bookcase/jewelry armoire": "bookshelf",
    "tv stand": "tv_stand",
    "wardrobe": "wardrobe",
    "lounge chair/cafe chair/office chair": "chair",
    "dining chair": "chair",
    "classic chinese chair": "chair",
    "armchair": "armchair",
    "dressing table": "dressing_table",
    "dressing chair": "dressing_chair",
    "corner/side table": "table",
    "dining table": "table",
    "round end table": "table",
    "drawer chest/corner cabinet": "cabinet",
    "sideboard/side cabinet/console table": "cabinet",
    "children cabinet": "children_cabinet",
    "shelf": "shelf",
    "footstool/sofastool/bed end stool/stool": "stool",
    "coffee table": "coffee_table",
    "loveseat sofa": "sofa",
    "three-seat/multi-seat sofa": "sofa",
    "l-shaped sofa": "sofa",
    "lazy sofa": "sofa",
    "chaise longue sofa": "sofa",
}

_COMMON_LIVING = {
    "bookcase/jewelry armoire": "bookshelf",
    "desk": "desk",
    "pendant lamp": "pendant_lamp",
    "ceiling lamp": "ceiling_lamp",
    "lounge chair/cafe chair/office chair": "lounge_chair",
    "dining chair": "dining_chair",
    "dining table": "dining_table",
    "corner/side table": "corner_side_table",
    "classic chinese chair": "chinese_chair",
    "armchair": "armchair",
    "shelf": "shelf",
    "sideboard/side cabinet/console table": "console_table",
    "footstool/sofastool/bed end stool/stool": "stool",
    "barstool": "stool",
    "round end table": "round_end_table",
    "loveseat sofa": "loveseat_sofa",
    "drawer chest/corner cabinet": "cabinet",
    "wardrobe": "wardrobe",
    "three-seat/multi-seat sofa": "multi_seat_sofa",
    "wine cabinet": "wine_cabinet",
    "coffee table": "coffee_table",
    "lazy sofa": "lazy_sofa",
    "children cabinet": "cabinet",
    "chaise longue sofa": "chaise_longue_sofa",
    "l-shaped sofa": "l_shaped_sofa",
    "dressing table": "dressing_table",
    "dressing chair": "dressing_chair",
}

THREED_FRONT_LIBRARY_FURNITURE = dict(_COMMON_LIVING)
THREED_FRONT_LIVINGROOM_FURNITURE = {
    k: v for k, v in _COMMON_LIVING.items()
    if k not in ("dressing table", "dressing chair")
}
THREED_FRONT_LIVINGROOM_FURNITURE["tv stand"] = "tv_stand"


# ---------------------------------------------------------------------------
# splits (capability of reference ``splits_builder.py``)


def read_splits(annotation_csv: str,
                keep=("train", "val")) -> List[str]:
    """Scene ids of the kept splits from a (scene_id, split) csv."""
    if isinstance(keep, str):
        keep = (keep,)
    with open(annotation_csv) as f:
        rows = [r for r in csv.reader(f) if len(r) >= 2]
    wanted = set(keep)
    return [r[0] for r in rows if r[1] in wanted]


# ---------------------------------------------------------------------------
# room filters: free functions returning Room -> Room | None


def keep_if(pred: Callable[[Room], bool]) -> RoomFilter:
    return lambda room: room if pred(room) else None


def room_type_contains(token: str) -> RoomFilter:
    return keep_if(lambda r: token in r.scene_type)


def at_least_boxes(n: int) -> RoomFilter:
    return keep_if(lambda r: len(r.bboxes) >= n)


def at_most_boxes(n: int) -> RoomFilter:
    return keep_if(lambda r: len(r.bboxes) <= n)


def labels_within(vocab) -> RoomFilter:
    return keep_if(lambda r: all(b.label in vocab for b in r.bboxes))


def contains_any_label(labels) -> RoomFilter:
    wanted = set(labels)
    return keep_if(lambda r: any(b.label in wanted for b in r.bboxes))


def keep_scene_ids(ids) -> RoomFilter:
    ids = set(ids)
    return keep_if(lambda r: r.scene_id in ids)


def drop_scene_ids(ids) -> RoomFilter:
    ids = set(ids)
    return keep_if(lambda r: r.scene_id not in ids)


def without_bad_jids(invalid_jids) -> RoomFilter:
    bad = set(invalid_jids)
    return keep_if(lambda r: not any(b.jid in bad for b in r.bboxes))


def room_extent_within(lo: float, hi: float, axis: int = 1) -> RoomFilter:
    """Furniture-bbox extent window along one axis: hi-corner <= ``hi`` and
    lo-corner >= ``lo`` (reference ``room_smaller/larger_than_along_axis``,
    ``common.py:100-110``)."""
    def pred(room: Room) -> bool:
        bbox_lo, bbox_hi = room.bbox
        return bbox_hi[axis] <= hi and bbox_lo[axis] >= lo
    return keep_if(pred)


def floor_plan_within(limit_x: float, limit_y: float,
                      axes=(0, 2)) -> RoomFilter:
    def pred(room: Room) -> bool:
        lo, hi = room.floor_plan_bbox
        return (hi[axes[0]] - lo[axes[0]] <= limit_x
                and hi[axes[1]] - lo[axes[1]] <= limit_y)
    return keep_if(pred)


def relabel(mapping: Mapping[str, str]) -> RoomFilter:
    """Remap raw categories to the generic training vocabulary (in place,
    like the reference's ``with_generic_classes``)."""
    def run(room: Room) -> Room:
        for box in room.bboxes:
            box.label = mapping[box.label]
        return room
    return run


def drop_box_labels(labels) -> RoomFilter:
    """Remove matching boxes, keep the room."""
    bad = set(labels)
    def run(room: Room) -> Room:
        room.bboxes[:] = [b for b in room.bboxes if b.label not in bad]
        return room
    return run


def compose_filters(*steps: RoomFilter) -> RoomFilter:
    def run(room: Optional[Room]) -> Optional[Room]:
        for step in steps:
            if not room:
                return None
            room = step(room)
        return room or None
    return run


@dataclass(frozen=True)
class RoomFilterSpec:
    """Per-room-type filter parameters (reference
    ``datasets/__init__.py:78-184`` as a table; thresholds are part of the
    published dataset contract — see NOTICE)."""

    room_token: str
    vocab: Mapping[str, str]
    min_boxes: int = 3
    max_boxes: Optional[int] = None
    must_contain: Tuple[str, ...] = ()
    floor_limit: float = 6.0


ROOM_FILTER_SPECS: Dict[str, RoomFilterSpec] = {
    "bedroom": RoomFilterSpec(
        "bed", THREED_FRONT_BEDROOM_FURNITURE, max_boxes=13,
        must_contain=("double_bed", "single_bed", "kids_bed")),
    "livingroom": RoomFilterSpec(
        "living", THREED_FRONT_LIVINGROOM_FURNITURE, max_boxes=21,
        floor_limit=12.0),
    "diningroom": RoomFilterSpec(
        "dining", THREED_FRONT_LIVINGROOM_FURNITURE, max_boxes=21,
        floor_limit=12.0),
    "library": RoomFilterSpec("library", THREED_FRONT_LIBRARY_FURNITURE),
}


def room_filter(spec: RoomFilterSpec, invalid_scene_ids=(),
                invalid_jids=(), split_scene_ids=(),
                without_lamps: bool = False) -> RoomFilter:
    """The full filter chain for one room type, in the reference's
    application order (size checks before lamp removal, vocabulary check
    before relabeling)."""
    steps: List[RoomFilter] = [
        room_type_contains(spec.room_token),
        at_least_boxes(spec.min_boxes),
    ]
    if spec.max_boxes is not None:
        steps.append(at_most_boxes(spec.max_boxes))
    steps += [
        labels_within(spec.vocab),
        relabel(spec.vocab),
        drop_scene_ids(invalid_scene_ids),
        without_bad_jids(invalid_jids),
    ]
    if spec.must_contain:
        steps.append(contains_any_label(spec.must_contain))
    steps += [
        room_extent_within(-0.005, 4.0, axis=1),
        floor_plan_within(spec.floor_limit, spec.floor_limit),
        drop_box_labels(("ceiling_lamp", "pendant_lamp")
                        if without_lamps else ()),
        keep_scene_ids(split_scene_ids),
    ]
    return compose_filters(*steps)


def filter_function(config, split=("train", "val"), without_lamps=False
                    ) -> RoomFilter:
    """Filter chain named by ``config["filter_fn"]``
    (reference ``datasets/__init__.py:78-184``)."""
    name = config["filter_fn"]
    if name == "no_filtering":
        return lambda room: room
    if name == "non_empty":
        return at_least_boxes(1)
    with open(config["path_to_invalid_scene_ids"]) as f:
        invalid_scene_ids = {line.strip() for line in f}
    with open(config["path_to_invalid_bbox_jids"]) as f:
        invalid_jids = {line.strip() for line in f}
    split_ids = read_splits(config["annotation_file"], split)
    for key, spec in ROOM_FILTER_SPECS.items():
        if f"threed_front_{key}" in name:
            return room_filter(spec, invalid_scene_ids, invalid_jids,
                               split_ids, without_lamps)
    raise NotImplementedError(name)


# ---------------------------------------------------------------------------
# raw dataset container with struct-of-arrays statistics


class ThreedFront:
    """Parsed 3D-FRONT rooms + dataset-wide statistics.

    Statistics are reductions over one concatenated struct-of-arrays table
    (:func:`~lsdm_tpu_torch.data.threed_front_scene.room_arrays` per room), cached
    after the first pass.
    """

    def __init__(self, scenes: Sequence[Room], bounds=None):
        assert len(scenes) > 0
        self.scenes = list(scenes)
        self._columns: Optional[Dict[str, np.ndarray]] = None
        self._bounds = dict(bounds) if bounds is not None else None

    def __len__(self):
        return len(self.scenes)

    def __getitem__(self, idx):
        return self.scenes[idx]

    def __str__(self):
        return (f"Dataset contains {len(self.scenes)} scenes with "
                f"{self.n_object_types} discrete types")

    def post_process(self, sample):
        return sample

    # -- the flat table ----------------------------------------------------
    def _table(self) -> Dict[str, np.ndarray]:
        if self._columns is None:
            per_room = [room_arrays(s) for s in self.scenes]
            self._columns = {
                k: np.concatenate([t[k] for t in per_room])
                for k in ("translations", "sizes", "angles")
            }
            self._columns["labels"] = np.array(
                [lab for t in per_room for lab in t["labels"]])
        return self._columns

    # -- bounds ------------------------------------------------------------
    @property
    def bounds(self) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
        if self._bounds is None:
            table = self._table()
            self._bounds = {
                k: (table[k].min(axis=0), table[k].max(axis=0))
                for k in ("translations", "sizes", "angles")
            }
        return self._bounds

    @property
    def centroids(self):
        return self.bounds["translations"]

    @property
    def sizes(self):
        return self.bounds["sizes"]

    @property
    def angles(self):
        return self.bounds["angles"]

    @property
    def bbox(self) -> Tuple[np.ndarray, np.ndarray]:
        lows, highs = zip(*(s.bbox for s in self.scenes))
        return (np.min(np.stack(lows), axis=0),
                np.max(np.stack(highs), axis=0))

    # -- class statistics --------------------------------------------------
    @property
    def count_furniture(self) -> "OrderedDict[str, int]":
        counts = Counter(self._table()["labels"].tolist())
        return OrderedDict(sorted(counts.items(), key=lambda kv: -kv[1]))

    @property
    def class_order(self) -> Dict[str, int]:
        return {label: i for i, label in enumerate(self.count_furniture)}

    @property
    def class_frequencies(self) -> Dict[str, float]:
        counts = self.count_furniture
        total = sum(counts.values())
        return {k: v / total for k, v in counts.items()}

    @property
    def object_types(self) -> List[str]:
        return sorted(set(self._table()["labels"].tolist()))

    @property
    def n_object_types(self) -> int:
        return len(self.object_types)

    @property
    def class_labels(self) -> List[str]:
        return self.object_types + ["start", "end"]

    @property
    def n_classes(self) -> int:
        return len(self.class_labels)

    @property
    def room_types(self):
        return set(s.scene_type for s in self.scenes)

    @property
    def count_objects_in_rooms(self):
        return Counter(len(s.bboxes) for s in self.scenes)

    @classmethod
    def from_dataset_directory(cls, dataset_directory, path_to_model_info,
                               path_to_models, path_to_room_masks_dir=None,
                               path_to_bounds=None, filter_fn=lambda s: s):
        scenes = parse_threed_front_scenes(
            dataset_directory, path_to_model_info, path_to_models,
            path_to_room_masks_dir)
        bounds = None
        if path_to_bounds:
            bounds = np.load(path_to_bounds, allow_pickle=True)
        return cls([s for s in map(filter_fn, scenes) if s], bounds)


# ---------------------------------------------------------------------------
# preprocessed ("cached") rooms: boxes.npz + train_stats reader


@dataclass(frozen=True)
class DatasetStats:
    """The ``dataset_stats`` json of a preprocessed 3D-FRONT cache
    (reference ``threed_front.py:300-329``)."""

    class_labels: List[str]
    object_types: List[str]
    class_frequencies: Dict[str, float]
    class_order: Dict[str, int]
    count_furniture: Dict[str, int]
    bounds: Dict[str, Tuple[np.ndarray, np.ndarray]]

    @classmethod
    def from_json(cls, path: str) -> "DatasetStats":
        with open(path) as f:
            raw = json.load(f)
        def pair(values, split_at):
            arr = np.asarray(values, np.float64)
            return arr[:split_at], arr[split_at:]
        return cls(
            class_labels=raw["class_labels"],
            object_types=raw["object_types"],
            class_frequencies=raw["class_frequencies"],
            class_order=raw["class_order"],
            count_furniture=raw["count_furniture"],
            bounds={
                "translations": pair(raw["bounds_translations"], 3),
                "sizes": pair(raw["bounds_sizes"], 3),
                "angles": pair(raw["bounds_angles"], 1),
            })


class CachedRoom(NamedTuple):
    scene_id: str
    room_layout: np.ndarray  # (H, W) float in [0, 1]
    floor_plan_vertices: np.ndarray
    floor_plan_faces: np.ndarray
    floor_plan_centroid: np.ndarray
    class_labels: np.ndarray
    translations: np.ndarray
    sizes: np.ndarray
    angles: np.ndarray
    image_path: str

    @property
    def floor_plan(self):
        return (np.copy(self.floor_plan_vertices),
                np.copy(self.floor_plan_faces))

    @property
    def room_mask(self):
        return self.room_layout[:, :, None]


class CachedThreedFrontRooms:
    """Reader over the standard preprocessed layout
    ``<base_dir>/<RoomType_sceneid>/boxes.npz`` (+ renders + a
    ``train_stats`` json; reference ``threed_front.py:182-299``).

    Statistics come from :class:`DatasetStats`; the encoding layer composes
    over :meth:`get_room_params`.
    """

    _RENDER_NAMES = ("rendered_scene_256.png",
                     "rendered_scene_256_no_lamps.png")

    def __init__(self, base_dir: str, config: Mapping, scene_ids):
        self._base_dir = base_dir
        self.config = dict(config)
        self.stats = DatasetStats.from_json(
            os.path.join(base_dir, config["train_stats"]))
        wanted = set(scene_ids)
        self._tags = sorted(
            d for d in os.listdir(base_dir)
            if "_" in d and d.split("_")[1] in wanted)
        render = self._RENDER_NAMES[0]
        if self._tags and not os.path.isfile(
                os.path.join(base_dir, self._tags[0], render)):
            render = self._RENDER_NAMES[1]
        self._render_name = render
        self._layout_hw = tuple(
            int(v) for v in self.config["room_layout_size"].split(","))

    def __len__(self):
        return len(self._tags)

    def _room_dir(self, i: int) -> str:
        return os.path.join(self._base_dir, self._tags[i])

    def _resized_layout(self, layout: np.ndarray) -> np.ndarray:
        """uint8 (H, W, 1) -> float (h, w) in [0, 1] at the configured
        size."""
        from PIL import Image

        img = Image.fromarray(layout[:, :, 0]).resize(
            self._layout_hw, resample=Image.BILINEAR)
        return np.asarray(img).astype(np.float32) / np.float32(255)

    def __getitem__(self, i: int) -> CachedRoom:
        with np.load(os.path.join(self._room_dir(i), "boxes.npz")) as d:
            return CachedRoom(
                scene_id=d["scene_id"],
                room_layout=self._resized_layout(d["room_layout"]),
                floor_plan_vertices=d["floor_plan_vertices"],
                floor_plan_faces=d["floor_plan_faces"],
                floor_plan_centroid=d["floor_plan_centroid"],
                class_labels=d["class_labels"],
                translations=d["translations"],
                sizes=d["sizes"],
                angles=d["angles"],
                image_path=os.path.join(self._room_dir(i),
                                        self._render_name))

    def get_room_params(self, i: int) -> Sample:
        with np.load(os.path.join(self._room_dir(i), "boxes.npz")) as d:
            return {
                "room_layout": self._resized_layout(d["room_layout"])[None],
                "class_labels": np.asarray(d["class_labels"]),
                "translations": np.asarray(d["translations"]),
                "sizes": np.asarray(d["sizes"]),
                "angles": np.asarray(d["angles"]),
            }

    def post_process(self, sample):
        return sample

    # -- stats delegation --------------------------------------------------
    @property
    def bounds(self):
        return self.stats.bounds

    @property
    def class_labels(self):
        return self.stats.class_labels

    @property
    def n_classes(self):
        return len(self.stats.class_labels)

    @property
    def object_types(self):
        return self.stats.object_types

    @property
    def n_object_types(self):
        return len(self.stats.object_types)

    @property
    def class_frequencies(self):
        return self.stats.class_frequencies

    @property
    def class_order(self):
        return self.stats.class_order

    @property
    def count_furniture(self):
        return self.stats.count_furniture


# ---------------------------------------------------------------------------
# encoding pipeline: pure sample -> sample transforms

#: fallback square layout mask edge for raw rooms without a mask render
DEFAULT_LAYOUT_SIZE = 64


def minmax_scale(x, lo, hi):
    """[-1, 1] min-max scaling with clipping
    (``threed_front_dataset.py:309-325``)."""
    x = np.clip(np.asarray(x, np.float32), lo, hi)
    return 2.0 * (x - lo) / (hi - lo) - 1.0


def minmax_unscale(x, lo, hi):
    return (np.asarray(x) + 1.0) / 2.0 * (hi - lo) + lo


def rotate_y(points: np.ndarray, theta: float) -> np.ndarray:
    """Row-vector y-rotation matching the reference's ``v.dot(R)`` with its
    R[0,2] = -sin convention (``threed_front_dataset.py:253-263``):
    x' = x·cos + z·sin, z' = -x·sin + z·cos."""
    c, s = np.cos(theta), np.sin(theta)
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    return np.stack([x * c + z * s, y, -x * s + z * c], axis=-1)


def scaled(bounds) -> Transform:
    def run(sample: Sample) -> Sample:
        for k, (lo, hi) in bounds.items():
            if k in sample:
                sample[k] = minmax_scale(sample[k], lo, hi)
        return sample
    return run


def descale_sample(sample: Sample, bounds) -> Sample:
    """Invert :func:`scaled` on every bounded key (class labels and layout
    pass through)."""
    return {
        k: (v if k in ("room_layout", "class_labels")
            else minmax_unscale(v, *bounds[k]))
        for k, v in sample.items()
    }


def rotation_augmented(bounds, min_rad=0.174533, max_rad=5.06145
                       ) -> Transform:
    """Random y-rotation of the whole room, half the time
    (``threed_front_dataset.py:250-306``; angle window is the published
    augmentation contract — see NOTICE).  Angles wrap into
    [angle_min, angle_min + 2pi)."""
    def run(sample: Sample) -> Sample:
        theta = (np.random.uniform(min_rad, max_rad)
                 if np.random.rand() < 0.5 else 0.0)
        if "translations" in sample:
            sample["translations"] = rotate_y(sample["translations"], theta)
        if "angles" in sample:
            lo = bounds["angles"][0]
            sample["angles"] = (
                (sample["angles"] + theta - lo) % (2 * np.pi) + lo)
        if "room_layout" in sample:
            from scipy.ndimage import rotate

            img = np.transpose(sample["room_layout"], (1, 2, 0))
            img = rotate(img, theta * 180.0 / np.pi, reshape=False)
            sample["room_layout"] = np.transpose(img, (2, 0, 1))
        return sample
    return run


def jittered(sigma: float = 0.01) -> Transform:
    """Reference quirk kept (``threed_front_dataset.py:351-360``): ONE
    scalar normal draw per property, added uniformly — not per-element
    noise."""
    def run(sample: Sample) -> Sample:
        for k in sample:
            if k not in ("room_layout", "class_labels"):
                sample[k] = sample[k] + np.random.normal(0, sigma)
        return sample
    return run


def permuted(keys=BOX_KEYS) -> Transform:
    def run(sample: Sample) -> Sample:
        order = np.random.permutation(sample["class_labels"].shape[0])
        for k in keys:
            sample[k] = sample[k][order]
        return sample
    return run


def freq_ordered(class_frequencies, class_labels, keys=BOX_KEYS
                 ) -> Transform:
    """Most-frequent-class-first reorder: one reversed lexsort with class
    frequency as the primary key, translations breaking ties
    (``threed_front_dataset.py:389-408``)."""
    def run(sample: Sample) -> Sample:
        ints = sample["class_labels"].argmax(-1)
        freqs = np.array([[class_frequencies[class_labels[i]]]
                          for i in ints])
        order = np.lexsort(
            np.hstack([sample["translations"], freqs]).T)[::-1]
        for k in keys:
            sample[k] = sample[k][order]
        return sample
    return run


def with_end_targets() -> Transform:
    """Append the stop symbol and emit the shifted ``*_tr`` target track:
    class labels gain an end-label row, numeric properties a zero row
    (``threed_front_dataset.py:411-446``)."""
    def run(sample: Sample) -> Sample:
        targets = {}
        for k, v in sample.items():
            if k in ("room_layout", "length"):
                continue
            rows, cols = v.shape
            extra = (np.eye(cols)[-1] if k == "class_labels"
                     else np.zeros(cols))
            targets[k + "_tr"] = np.vstack([v, extra])
        sample.update(targets)
        sample["length"] = sample["class_labels"].shape[0]
        return sample
    return run


def wocm_split() -> Transform:
    """"Without causal masking": draw a split point m in [0, L]; boxes
    before m are the context, target row m (possibly the end symbol) is the
    prediction (``threed_front_dataset.py:449-467``)."""
    def run(sample: Sample) -> Sample:
        n_ctx = np.random.randint(0, sample["class_labels"].shape[0] + 1)
        for k, v in sample.items():
            if k in ("room_layout", "length"):
                continue
            sample[k] = v[n_ctx] if k.endswith("_tr") else v[:n_ctx]
        sample["length"] = n_ctx
        return sample
    return run


def collate_padded(samples: Sequence[Sample]) -> Dict[str, np.ndarray]:
    """Batch variable-length samples: 2-D per-box arrays zero-pad to the
    batch max length, everything else stacks; adds ``lengths``; ``*_tr``
    targets gain a singleton box axis.  float32 numpy out — feed to jnp
    directly (``threed_front_dataset.py:205-247``)."""
    max_len = max(s["length"] for s in samples)
    out: Dict[str, np.ndarray] = {}
    for k in samples[0]:
        if k == "length":
            continue
        if np.ndim(samples[0][k]) == 2:  # (boxes, feat): pad the box axis
            out[k] = np.stack([
                np.vstack([s[k], np.zeros((max_len - len(s[k]),
                                           np.shape(s[k])[1]))])
                for s in samples
            ])
        else:
            out[k] = np.stack([s[k] for s in samples])
    out["lengths"] = np.array([s["length"] for s in samples])
    out = {k: np.asarray(v, np.float32) for k, v in out.items()}
    return {k: (v[:, None] if "_tr" in k else v) for k, v in out.items()}


class EncodedRooms:
    """A dataset view: base sample builder + a pipeline of pure transforms.

    Replaces the reference's 12-class decorator tower
    (``threed_front_dataset.py:18-467``) — every encoding is the same class
    with a different pipeline, assembled by
    :func:`dataset_encoding_factory`.
    """

    #: translation (3) + size (3) + angle (1) — the box regression width
    bbox_dims = 7

    def __init__(self, source, sample_fn: Callable[[int], Sample],
                 transforms: Sequence[Transform], scaled_output: bool):
        self._source = source
        self._sample_fn = sample_fn
        self._transforms = list(transforms)
        self._scaled_output = scaled_output

    def __len__(self):
        return len(self._source)

    def __getitem__(self, idx: int) -> Sample:
        sample = self._sample_fn(idx)
        for transform in self._transforms:
            sample = transform(sample)
        return sample

    @staticmethod
    def collate_fn(samples):
        return collate_padded(samples)

    def post_process(self, sample: Sample) -> Sample:
        if self._scaled_output:
            sample = descale_sample(sample, self.bounds)
        return self._source.post_process(sample)

    # -- stats delegation --------------------------------------------------
    @property
    def bounds(self):
        return self._source.bounds

    @property
    def class_labels(self):
        return self._source.class_labels

    @property
    def n_classes(self):
        return self._source.n_classes

    @property
    def class_frequencies(self):
        return self._source.class_frequencies

    @property
    def object_types(self):
        return self._source.object_types

    @property
    def n_object_types(self):
        return self._source.n_object_types

    @property
    def feature_size(self):
        return self.bbox_dims + self.n_classes


def raw_room_sample(dataset, box_ordering=None, with_layout=True
                    ) -> Callable[[int], Sample]:
    """Base sample builder over parsed rooms: the struct-of-arrays table +
    one-hot labels (the reference's five per-property encoder classes,
    ``threed_front_dataset.py:121-202``, as one function).

    Deviation: rooms without a mask render get a constant ones layout of
    ``DEFAULT_LAYOUT_SIZE`` (the reference crashes).
    """
    labels = dataset.class_labels

    def build(idx: int) -> Sample:
        room = dataset[idx]
        arrays = room_arrays(room)
        if box_ordering == "class_frequencies":
            order = box_order(room, class_rank=dataset.class_frequencies)
        elif box_ordering is None:
            order = np.arange(len(room.bboxes))
        else:
            raise NotImplementedError(box_ordering)
        onehot = np.stack([
            np.eye(len(labels), dtype=np.float32)[labels.index(lab)]
            for lab in arrays["labels"]
        ])
        sample = {
            "class_labels": onehot[order],
            "translations": arrays["translations"][order].astype(np.float32),
            "sizes": arrays["sizes"][order].astype(np.float32),
            "angles": arrays["angles"][order].astype(np.float32),
        }
        if with_layout:
            if room.room_mask_path is not None:
                mask = room.room_mask[:, :, 0:1]
            else:
                mask = np.ones(
                    (DEFAULT_LAYOUT_SIZE, DEFAULT_LAYOUT_SIZE, 1),
                    np.float32)
            sample["room_layout"] = np.transpose(mask, (2, 0, 1))
        return sample

    return build


def dataset_encoding_factory(name, dataset, augmentations=None,
                             box_ordering=None) -> EncodedRooms:
    """Assemble the encoding pipeline named ``name``
    (``threed_front_dataset.py:470-534``).

    Pipeline order (the reference's decorator nesting, innermost first):
    base sample -> [cached: class-frequency order] -> augmentations ->
    [-1, 1] scale -> [wocm: permutation] -> end-target append -> WOCM split.
    """
    pipeline: List[Transform] = []
    if "cached" in name:
        sample_fn = dataset.get_room_params
        if box_ordering == "class_frequencies":
            pipeline.append(freq_ordered(dataset.class_frequencies,
                                         dataset.class_labels))
        elif box_ordering is not None:
            raise NotImplementedError(box_ordering)
    else:
        if name == "basic":
            return EncodedRooms(
                dataset, raw_room_sample(dataset, box_ordering,
                                         with_layout=False),
                [], scaled_output=False)
        sample_fn = raw_room_sample(dataset, box_ordering)

    for aug in (augmentations or []):
        if aug == "rotations":
            pipeline.append(rotation_augmented(dataset.bounds))
        elif aug == "jitter":
            pipeline.append(jittered())

    pipeline.append(scaled(dataset.bounds))
    if "eval" in name:
        return EncodedRooms(dataset, sample_fn, pipeline, scaled_output=True)
    if "wocm_no_prm" in name:
        pipeline += [with_end_targets(), wocm_split()]
    elif "wocm" in name:
        pipeline += [permuted(), with_end_targets(), wocm_split()]
    else:
        raise NotImplementedError(f"unknown encoding {name!r}")
    return EncodedRooms(dataset, sample_fn, pipeline, scaled_output=True)


# ---------------------------------------------------------------------------
# top-level entry points (reference ``datasets/__init__.py:18-75``)


def get_raw_dataset(config, filter_fn=lambda s: s, path_to_bounds=None,
                    split=("train", "val")):
    if "cached" in config["dataset_type"]:
        return CachedThreedFrontRooms(
            config["dataset_directory"], config,
            read_splits(config["annotation_file"], split))
    return ThreedFront.from_dataset_directory(
        config["dataset_directory"],
        config["path_to_model_info"],
        config["path_to_models"],
        config.get("path_to_room_masks_dir"),
        path_to_bounds, filter_fn)


def get_dataset_raw_and_encoded(config, filter_fn=lambda s: s,
                                path_to_bounds=None, augmentations=None,
                                split=("train", "val")):
    dataset = get_raw_dataset(config, filter_fn, path_to_bounds, split)
    encoding = dataset_encoding_factory(
        config.get("encoding_type"), dataset, augmentations,
        config.get("box_ordering"))
    return dataset, encoding


def get_encoded_dataset(config, filter_fn=lambda s: s, path_to_bounds=None,
                        augmentations=None, split=("train", "val")):
    _, encoding = get_dataset_raw_and_encoded(
        config, filter_fn, path_to_bounds, augmentations, split)
    return encoding
