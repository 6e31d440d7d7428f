"""3D-FRONT scene layer: placement geometry, model library, room records.

A copy of ``lsdm_tpu/data/threed_front_scene.py`` (host numpy; the port
imports nothing of the JAX package), reading meshes with the port's
``ops/spiral.py:load_obj``; PIL stays a lazy import.

From-scratch design of the capability covered by the reference's vendored
NVIDIA scene objects (``atiss/scene_synthesis/datasets/threed_front_scene.py``
+ the parsing half of ``datasets/utils.py``).  Built around three ideas the
reference does not have:

  1. **Closed-form placement geometry.**  The reference extracts the
     placement rotation with ``axis = cross([0,0,1], rotation[1:])`` /
     ``theta = 2*arccos(dot([0,0,1], rotation[1:]))`` over the stored
     (x, y, z, w) quaternion — which algebraically reduces to axis
     ``(-z, y, 0)`` and angle ``2*arccos(w)`` (the x component is ignored).
     We implement that reduction directly (:func:`placement_axis_angle`,
     Rodrigues rotation), and box half-extents collapse to
     ``(aabb_hi - aabb_lo) * scale / 2`` — a rigid rotation preserves edge
     lengths, so no corner arithmetic is needed
     (cf. ``threed_front_scene.py:270-277``).
  2. **A memoized model library.**  CAD-mesh bounding boxes are loaded once
     per unique model id (:class:`ModelLibrary`), instead of once per placed
     instance with ``bbox_vertices.npy`` sidecar writes into the model
     directory (cf. ``threed_front_scene.py:317-324``; existing sidecars are
     still read, never written).
  3. **A struct-of-arrays room table.**  :func:`room_arrays` exposes each
     room as flat ``(L, ·)`` numpy arrays (labels / translations / sizes /
     angles) computed in one vectorized pass — the representation the
     encoding layer (``threed_front_dataset.py``) composes over.

Behavioral contracts preserved from the reference (trained checkpoints and
the preprocessed dataset format depend on them; each cited in place):
placement-quaternion quirks (degenerate-rotation tests, NaN pass-through),
the scale-sanity and duplicate-room filters in scene parsing, pickle caches
behind ``PATH_TO_SCENES`` / ``PATH_TO_3D_FUTURE_OBJECTS``, and box-ordering
tie-break semantics.

Deviations (deliberate, documented): mesh IO via
:func:`lsdm_tpu_torch.ops.spiral.load_obj` with ``(vertices, faces)`` tuples, no
GUI/simple_3dviz rendering surface, no sidecar cache writes, and rooms with
no mask file report ``room_mask_path = None`` instead of crashing.
"""

from __future__ import annotations

import json
import os
import pickle
from collections import Counter
from dataclasses import dataclass, field, replace
from typing import Dict, Iterator, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from lsdm_tpu_torch.ops.spiral import load_obj

Mesh = Tuple[np.ndarray, np.ndarray]  # (vertices (V, 3), faces (F, 3))


# ---------------------------------------------------------------------------
# placement geometry kernels (pure, vectorized)


def placement_axis_angle(quat: Sequence[float]) -> Tuple[np.ndarray, float]:
    """Rotation axis/angle a 3D-FRONT placement quaternion encodes *under the
    reference's read* of the stored (x, y, z, w) layout.

    The reference treats ``rotation[1:] = (y, z, w)`` as a 3-vector and takes
    ``cross([0,0,1], ·)`` / ``2*arccos(dot([0,0,1], ·))``
    (``threed_front_scene.py:161-174``), which is exactly axis ``(-z, y, 0)``
    with angle ``2*arccos(w)``: the x component never participates.  For the
    pure y-rotations 3D-FRONT actually contains (x = z = 0) this recovers the
    standard axis-angle; we keep the reduced form so degenerate inputs keep
    the reference's semantics (NaN angle when |w| > 1, "no rotation" when the
    axis components cancel — see :func:`_placement_is_identity`).
    """
    x, y, z, w = (float(q) for q in quat)
    del x  # ignored by the reference's read — see docstring
    return np.array([-z, y, 0.0]), 2.0 * np.arccos(w)


def _placement_is_identity(axis: np.ndarray, theta: float) -> bool:
    """Reference skip-rotation test: ``sum(axis) == 0 or isnan(theta)``
    (``threed_front_scene.py:159``).  With axis (-z, y, 0) the sum is
    ``y - z`` — identity quats (y = z = 0) hit it; so would the never-seen
    y == z != 0 case, a quirk we reproduce rather than repair."""
    return float(np.sum(axis)) == 0.0 or bool(np.isnan(theta))


def rotation_about(axis: np.ndarray, theta: float) -> np.ndarray:
    """Rodrigues rotation matrix about ``axis`` (normalized here) by
    ``theta``: R = I + sin(t)·K + (1 - cos(t))·K² with K the cross-product
    matrix.  Numerically equal to the reference's expanded quaternion-product
    matrix (``threed_front_scene.py:36-46``)."""
    a = np.asarray(axis, np.float64)
    a = a / np.linalg.norm(a)
    K = np.array([
        [0.0, -a[2], a[1]],
        [a[2], 0.0, -a[0]],
        [-a[1], a[0], 0.0],
    ])
    return np.eye(3) + np.sin(theta) * K + (1.0 - np.cos(theta)) * (K @ K)


def apply_placement(points: np.ndarray, scale, quat, position) -> np.ndarray:
    """Scale -> rotate -> translate, the 3D-Front-Toolbox json2obj convention
    (``threed_front_scene.py:161-174``).  ``points`` is (..., 3)."""
    pts = np.asarray(points, np.float64) * np.asarray(scale, np.float64)
    axis, theta = placement_axis_angle(quat)
    if not _placement_is_identity(axis, theta):
        pts = pts @ rotation_about(axis, theta).T
    return pts + np.asarray(position, np.float64)


def placement_y_angles(quats: np.ndarray) -> np.ndarray:
    """Vectorized y-axis angle of (L, 4) placement quaternions, wrapped to
    (-pi, pi] with the sign of the y component
    (``threed_front_scene.py:288-305``).  Rows must encode pure y-rotations
    (z component 0) unless degenerate."""
    q = np.asarray(quats, np.float64).reshape(-1, 4)
    y, z, w = q[:, 1], q[:, 2], q[:, 3]
    with np.errstate(invalid="ignore"):
        theta = 2.0 * np.arccos(w)  # arccos range [0, pi] => theta in [0, 2pi]
    identity = ((y - z) == 0.0) | np.isnan(theta)
    if np.any((z != 0.0) & ~identity):
        raise ValueError("placement quaternion is not a pure y-rotation")
    theta = np.where(theta >= np.pi, theta - 2.0 * np.pi, theta)
    return np.where(identity, 0.0, np.sign(y) * theta)


def placement_rotations(quats: np.ndarray) -> np.ndarray:
    """Vectorized (L, 3, 3) placement rotation matrices (identity for
    degenerate rows)."""
    q = np.asarray(quats, np.float64).reshape(-1, 4)
    out = np.empty((len(q), 3, 3))
    for i, row in enumerate(q):  # L is tens of boxes; host-side
        axis, theta = placement_axis_angle(row)
        out[i] = (np.eye(3) if _placement_is_identity(axis, theta)
                  else rotation_about(axis, theta))
    return out


def concat_meshes(meshes: Sequence[Mesh]) -> Mesh:
    """Stack (vertices, faces) pairs into one mesh with reindexed faces."""
    verts, faces, base = [], [], 0
    for v, f in meshes:
        verts.append(v)
        faces.append(np.asarray(f) + base)
        base += len(v)
    return np.vstack(verts), np.vstack(faces)


# ---------------------------------------------------------------------------
# 3D-FUTURE model library


class Asset(NamedTuple):
    """Normalized metadata of one 3D-FUTURE model."""

    super_category: str
    category: str
    style: Optional[str] = None
    theme: Optional[str] = None
    material: Optional[str] = None

    @property
    def label(self) -> str:
        return self.category


def _normalize_category(raw: Optional[str], fallback: str) -> str:
    """Lower-case + collapse " / " separators, the reference's label
    normalization (``threed_front_scene.py:101-107``)."""
    return fallback if raw is None else raw.lower().replace(" / ", "/")


def load_model_info(path_to_model_info: str) -> Dict[str, Asset]:
    """``model_info.json`` -> model_jid -> :class:`Asset`."""
    with open(path_to_model_info) as f:
        records = json.load(f)
    return {
        m["model_id"]: Asset(
            _normalize_category(m.get("super-category"),
                                "unknown_super-category"),
            _normalize_category(m.get("category"), "unknown_category"),
            m.get("style"), m.get("theme"), m.get("material"))
        for m in records
    }


class ModelLibrary:
    """Memoized access to the 3D-FUTURE CAD library: metadata + model-space
    AABBs, one mesh load per unique model id (the reference reloads per
    placed instance and writes ``bbox_vertices.npy`` sidecars; we read an
    existing sidecar but never write one)."""

    def __init__(self, path_to_models: str, path_to_model_info: str = ""):
        self.path_to_models = path_to_models
        self.assets: Dict[str, Asset] = (
            load_model_info(path_to_model_info) if path_to_model_info else {})
        self._aabbs: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}

    def model_dir(self, jid: str) -> str:
        return os.path.join(self.path_to_models, jid)

    def mesh_path(self, jid: str) -> str:
        return os.path.join(self.model_dir(jid), "raw_model.obj")

    def load_mesh(self, jid: str) -> Mesh:
        return load_obj(self.mesh_path(jid))

    def aabb(self, jid: str) -> Tuple[np.ndarray, np.ndarray]:
        """(lo, hi) of the untransformed CAD mesh, memoized per jid."""
        if jid not in self._aabbs:
            sidecar = os.path.join(self.model_dir(jid), "bbox_vertices.npy")
            try:  # precomputed corner cache shipped with the dataset
                corners = np.load(sidecar)
                lo, hi = corners.min(axis=0), corners.max(axis=0)
            except Exception:
                verts, _ = self.load_mesh(jid)
                lo, hi = verts.min(axis=0), verts.max(axis=0)
            self._aabbs[jid] = (np.asarray(lo, np.float64),
                                np.asarray(hi, np.float64))
        return self._aabbs[jid]


# ---------------------------------------------------------------------------
# placed objects


@dataclass
class PlacedFurniture:
    """One furniture placement: a library model + (scale, quat, position).

    Geometry accessors are thin closed-form wrappers over the placement
    kernels; the model AABB comes from the shared :class:`ModelLibrary`.
    ``label`` is mutable — dataset filters remap raw categories to the
    generic training vocabulary in place.
    """

    uid: str
    jid: str
    position: np.ndarray
    quat: np.ndarray  # stored (x, y, z, w)
    scale: np.ndarray
    library: ModelLibrary
    label: str = ""

    def __post_init__(self):
        if not self.label:
            asset = self.library.assets.get(self.jid)
            self.label = asset.label if asset else "unknown_category"

    # -- identity / assets ------------------------------------------------
    @property
    def model_uid(self) -> str:  # reference field names, for conversions
        return self.uid

    @property
    def model_jid(self) -> str:
        return self.jid

    @property
    def raw_model_path(self) -> str:
        return self.library.mesh_path(self.jid)

    @property
    def texture_image_path(self) -> str:
        return os.path.join(self.library.model_dir(self.jid), "texture.png")

    def raw_model(self) -> Mesh:
        return self.library.load_mesh(self.jid)

    def raw_model_transformed(self, offset=(0.0, 0.0, 0.0)) -> Mesh:
        v, f = self.raw_model()
        return (apply_placement(v, self.scale, self.quat, self.position)
                + np.asarray(offset)), f

    # -- closed-form box geometry ----------------------------------------
    @property
    def size(self) -> np.ndarray:
        """Half extents: ``(hi - lo) * scale / 2``.  Equal to the reference's
        corner-distance formulation (``threed_front_scene.py:270-277``)
        because the placement rotation is rigid."""
        lo, hi = self.library.aabb(self.jid)
        return (hi - lo) * np.asarray(self.scale, np.float64) / 2.0

    def corners(self, offset=(0.0, 0.0, 0.0)) -> np.ndarray:
        """The 8 transformed AABB corners, bit-ordered (index bits = x, y, z,
        z fastest) — the trimesh box ordering the preprocessed dataset's
        sidecar caches use (``threed_front_scene.py:317-324``)."""
        lo, hi = self.library.aabb(self.jid)
        bits = np.arange(8)
        sel = np.stack([(bits >> 2) & 1, (bits >> 1) & 1, bits & 1], axis=1)
        corners = np.where(sel, hi, lo)
        return (apply_placement(corners, self.scale, self.quat, self.position)
                + np.asarray(offset))

    def centroid(self, offset=(0.0, 0.0, 0.0)) -> np.ndarray:
        """Placed AABB center (mean of :meth:`corners`, computed directly —
        the placement is affine)."""
        lo, hi = self.library.aabb(self.jid)
        return (apply_placement((lo + hi) / 2.0, self.scale, self.quat,
                                self.position) + np.asarray(offset))

    def bottom_center(self, offset=(0.0, 0.0, 0.0)) -> np.ndarray:
        c = self.centroid(offset)
        return np.array([c[0], c[1] - self.size[1], c[2]])

    @property
    def bottom_size(self) -> np.ndarray:
        return self.size * np.array([1.0, 2.0, 1.0])

    @property
    def z_angle(self) -> float:
        return float(placement_y_angles(np.asarray(self.quat)[None])[0])

    # -- labels -----------------------------------------------------------
    def int_label(self, all_labels: Sequence[str]) -> int:
        return list(all_labels).index(self.label)

    def one_hot_label(self, all_labels: Sequence[str]) -> np.ndarray:
        return np.eye(len(all_labels))[self.int_label(all_labels)]

    def with_asset_of(self, other: "PlacedFurniture") -> "PlacedFurniture":
        """This placement, the other's CAD asset + scale — the retrieval
        swap (``threed_front_scene.py:383-394``; keeps this label)."""
        return replace(other, position=self.position, quat=self.quat,
                       label=self.label)


@dataclass
class ExtraMesh:
    """A wall/floor/door mesh carried verbatim in the scene JSON
    (``threed_front_scene.py:397-423``)."""

    uid: str
    jid: str
    xyz: np.ndarray
    faces: np.ndarray
    model_type: str
    position: np.ndarray
    quat: np.ndarray
    scale: np.ndarray

    def raw_model_transformed(self, offset=(0.0, 0.0, 0.0)) -> Mesh:
        verts = apply_placement(self.xyz, self.scale, self.quat,
                                self.position) + np.asarray(offset)
        return verts, np.asarray(self.faces)


# ---------------------------------------------------------------------------
# rooms


@dataclass
class Room:
    """One 3D-FRONT room: placed furniture + architectural extras.

    A plain record; dataset-level statistics live in the dataset layer
    (``threed_front_dataset.py``), geometry in the accessors below, and the
    flat numeric view in :func:`room_arrays`.
    """

    scene_id: str
    scene_type: str
    bboxes: List[PlacedFurniture]
    extras: List[ExtraMesh] = field(default_factory=list)
    json_stem: str = ""
    mask_dir: Optional[str] = None

    # -- identity ---------------------------------------------------------
    @property
    def uid(self) -> str:
        return f"{self.json_stem}_{self.scene_id}"

    @property
    def json_path(self) -> str:  # reference field name, for conversions
        return self.json_stem

    @property
    def nobjects(self) -> int:
        return len(self.bboxes)

    @property
    def furniture_in_room(self) -> List[str]:
        return [f.label for f in self.bboxes]

    @property
    def count_furniture_in_room(self) -> Counter:
        return Counter(self.furniture_in_room)

    @property
    def object_types(self) -> List[str]:
        return sorted(set(self.furniture_in_room))

    @property
    def n_object_types(self) -> int:
        return len(self.object_types)

    # -- geometry ---------------------------------------------------------
    @property
    def bbox(self) -> Tuple[np.ndarray, np.ndarray]:
        corners = np.vstack([f.corners() for f in self.bboxes])
        return corners.min(axis=0), corners.max(axis=0)

    @property
    def bboxes_centroid(self) -> np.ndarray:
        lo, hi = self.bbox
        return (lo + hi) / 2.0

    @property
    def floor_plan(self) -> Mesh:
        floors = [(e.xyz, e.faces) for e in self.extras
                  if e.model_type == "Floor"]
        v, f = concat_meshes(floors)
        return np.copy(v), np.copy(f)

    @property
    def floor(self) -> ExtraMesh:
        return next(e for e in self.extras if e.model_type == "Floor")

    @property
    def floor_plan_bbox(self) -> Tuple[np.ndarray, np.ndarray]:
        v, _ = self.floor_plan
        return v.min(axis=0), v.max(axis=0)

    @property
    def floor_plan_centroid(self) -> np.ndarray:
        lo, hi = self.floor_plan_bbox
        return (lo + hi) / 2.0

    @property
    def centroid(self) -> np.ndarray:
        return self.floor_plan_centroid

    # -- room mask --------------------------------------------------------
    @property
    def room_mask_path(self) -> Optional[str]:
        if self.mask_dir is None:
            return None
        return os.path.join(self.mask_dir, self.uid, "room_mask.png")

    @property
    def room_mask(self) -> np.ndarray:
        return self.room_mask_rotated(0.0)

    def room_mask_rotated(self, angle: float = 0.0) -> np.ndarray:
        """(H, W, 3) float layout mask, optionally rotated by ``angle`` rad
        (``threed_front_scene.py:503-509``)."""
        from PIL import Image

        im = Image.open(self.room_mask_path).convert("RGB")
        im = im.rotate(angle * 180.0 / np.pi, resample=Image.BICUBIC)
        return np.asarray(im).astype(np.float32) / np.float32(255)

    # -- labels -----------------------------------------------------------
    def category_counts(self, class_labels: Sequence[str]) -> List[int]:
        labels = list(class_labels)
        if "start" in labels and "end" in labels:
            labels = labels[:-2]
        counts = [0] * len(labels)
        for lab in self.furniture_in_room:
            counts[labels.index(lab)] += 1
        return counts

    # -- retrieval augmentation -------------------------------------------
    def augment_room(self, objects_dataset) -> "Room":
        """Swap one random furniture for its nearest-size library neighbour
        (``threed_front_scene.py:618-641``)."""
        target = np.random.choice(self.bboxes)
        query_size = target.size + np.random.normal(0, 0.02)
        found = objects_dataset.get_closest_furniture_to_box(
            target.label, query_size)
        swapped = [b for b in self.bboxes if b is not target]
        swapped.append(target.with_asset_of(found))
        return replace(self, scene_id=self.scene_id + "_augm", bboxes=swapped)


def room_arrays(room: Room, origin: Optional[np.ndarray] = None
                ) -> Dict[str, np.ndarray]:
    """Flat struct-of-arrays view of a room, vectorized over its boxes.

    Returns ``labels`` (list of str), ``translations (L, 3)`` (AABB centers
    relative to ``origin``, default the room centroid), ``sizes (L, 3)``
    (half extents) and ``angles (L, 1)`` — the numeric columns every encoder
    and statistics pass consumes.
    """
    boxes = room.bboxes
    if not boxes:
        return {"labels": [], "translations": np.zeros((0, 3)),
                "sizes": np.zeros((0, 3)), "angles": np.zeros((0, 1))}
    if origin is None:
        origin = room.centroid
    lo, hi = (np.stack(a) for a in zip(*(
        b.library.aabb(b.jid) for b in boxes)))  # (L, 3) each
    scales = np.stack([np.asarray(b.scale, np.float64) for b in boxes])
    quats = np.stack([np.asarray(b.quat, np.float64) for b in boxes])
    pos = np.stack([np.asarray(b.position, np.float64) for b in boxes])
    centers = (lo + hi) / 2.0 * scales
    R = placement_rotations(quats)  # (L, 3, 3)
    translations = np.einsum("lij,lj->li", R, centers) + pos - origin
    return {
        "labels": [b.label for b in boxes],
        "translations": translations,
        "sizes": (hi - lo) * scales / 2.0,
        "angles": placement_y_angles(quats)[:, None],
    }


def box_order(room: Room, class_rank: Optional[Dict[str, float]] = None,
              all_labels: Optional[Sequence[str]] = None) -> np.ndarray:
    """Deterministic box ordering indices via one lexsort over the room
    table.

    Default: lexsort on centroid columns (z primary)
    (``threed_front_scene.py:523-548``).  With ``all_labels``: integer label
    appended as the primary key.  With ``class_rank`` (label -> frequency):
    rank primary, order *reversed* — most frequent class first, the
    "class_frequencies" box ordering trained ATISS models expect.
    """
    cols = [room_arrays(room)["translations"]]
    rev = False
    if class_rank is not None:
        cols.append(np.array([[class_rank[b.label]] for b in room.bboxes]))
        rev = True
    elif all_labels is not None:
        cols.append(np.array([[b.int_label(all_labels)]
                              for b in room.bboxes]))
    order = np.lexsort(np.hstack(cols).T)
    return order[::-1] if rev else order


def ordered_boxes(room: Room, class_rank: Optional[Dict[str, float]] = None,
                  all_labels: Optional[Sequence[str]] = None
                  ) -> List[PlacedFurniture]:
    """Room boxes reordered by :func:`box_order`."""
    return [room.bboxes[i] for i in box_order(room, class_rank, all_labels)]


# ---------------------------------------------------------------------------
# raw 3D-FRONT JSON ingestion (capability of reference ``datasets/utils.py``)


def _scale_is_sane(scale: Sequence[float]) -> bool:
    """Reject degenerate/absurd placements (``utils.py:85-88``)."""
    return all(1e-5 <= s <= 5 for s in scale)


def _read_pickle(path: Optional[str]):
    if path and os.path.exists(path):
        with open(path, "rb") as f:
            return pickle.load(f)
    return None


def _write_pickle(path: Optional[str], obj) -> None:
    if path:
        with open(path, "wb") as f:
            pickle.dump(obj, f)


def _iter_scene_jsons(dataset_directory: str) -> Iterator[Tuple[str, dict]]:
    for name in sorted(os.listdir(dataset_directory)):
        if not name.endswith(".json"):
            continue
        with open(os.path.join(dataset_directory, name)) as f:
            yield name[: -len(".json")], json.load(f)


def _scene_tables(data: dict, library: ModelLibrary
                  ) -> Tuple[Dict[str, str], Dict[str, ExtraMesh]]:
    """Index one scene JSON: uid -> furniture jid, uid -> extra-mesh proto."""
    furniture = {f["uid"]: f["jid"] for f in data["furniture"]
                 if f.get("valid")}
    extras = {
        m["uid"]: ExtraMesh(
            uid=m["uid"], jid=m["jid"],
            xyz=np.asarray(m["xyz"], np.float64).reshape(-1, 3),
            faces=np.asarray(m["faces"]).reshape(-1, 3),
            model_type=m["type"], position=np.zeros(3),
            quat=np.array([0.0, 0.0, 0.0, 1.0]), scale=np.ones(3))
        for m in data["mesh"]
    }
    return furniture, extras


def parse_threed_front_scenes(dataset_directory, path_to_model_info,
                              path_to_models, path_to_room_masks_dir=None,
                              cache_path: Optional[str] = None) -> List[Room]:
    """Parse every scene JSON under ``dataset_directory`` into a flat list
    of :class:`Room`.

    Reference behaviors kept (``utils.py:78-121``): the ``PATH_TO_SCENES``
    env var (or ``cache_path``) short-circuits to a pickle; placements with
    insane scales invalidate the whole room; rooms need > 1 furniture; the
    first occurrence of each ``instanceid`` wins.
    """
    cache = os.getenv("PATH_TO_SCENES") or cache_path
    cached = _read_pickle(cache)
    if cached is not None:
        return cached

    library = ModelLibrary(path_to_models, path_to_model_info)
    rooms: List[Room] = []
    seen_ids = set()
    for stem, data in _iter_scene_jsons(dataset_directory):
        furniture, extras = _scene_tables(data, library)
        for rr in data["scene"]["room"]:
            placed: List[PlacedFurniture] = []
            extra_list: List[ExtraMesh] = []
            valid = True
            for child in rr["children"]:
                ref = child["ref"]
                if ref in furniture:
                    if not _scale_is_sane(child["scale"]):
                        valid = False
                        break
                    placed.append(PlacedFurniture(
                        uid=ref, jid=furniture[ref],
                        position=np.asarray(child["pos"], np.float64),
                        quat=np.asarray(child["rot"], np.float64),
                        scale=np.asarray(child["scale"], np.float64),
                        library=library))
                elif ref in extras:
                    extra_list.append(replace(
                        extras[ref],
                        position=np.asarray(child["pos"], np.float64),
                        quat=np.asarray(child["rot"], np.float64),
                        scale=np.asarray(child["scale"], np.float64)))
            if not valid or len(placed) <= 1:
                continue
            if rr["instanceid"] in seen_ids:
                continue
            seen_ids.add(rr["instanceid"])
            rooms.append(Room(
                scene_id=rr["instanceid"], scene_type=rr["type"].lower(),
                bboxes=placed, extras=extra_list, json_stem=stem,
                mask_dir=path_to_room_masks_dir))
    _write_pickle(cache, rooms)
    return rooms


def parse_threed_future_models(dataset_directory, path_to_models,
                               path_to_model_info,
                               cache_path: Optional[str] = None
                               ) -> List[PlacedFurniture]:
    """Unique furniture instances across all scenes (``utils.py:134-204``).

    Quirk kept: a bad scale ``break``s out of the room's child list, skipping
    its remaining children — reference behavior, not a bug fix target.
    """
    cache = os.getenv("PATH_TO_3D_FUTURE_OBJECTS") or cache_path
    cached = _read_pickle(cache)
    if cached is not None:
        return cached

    library = ModelLibrary(path_to_models, path_to_model_info)
    out: List[PlacedFurniture] = []
    seen = set()
    for _, data in _iter_scene_jsons(dataset_directory):
        furniture = {f["uid"]: f["jid"] for f in data["furniture"]
                     if f.get("valid")}
        for rr in data["scene"]["room"]:
            for child in rr["children"]:
                if child["ref"] not in furniture:
                    continue
                if not _scale_is_sane(child["scale"]):
                    break
                if child["ref"] in seen:
                    continue
                seen.add(child["ref"])
                out.append(PlacedFurniture(
                    uid=child["ref"], jid=furniture[child["ref"]],
                    position=np.asarray(child["pos"], np.float64),
                    quat=np.asarray(child["rot"], np.float64),
                    scale=np.asarray(child["scale"], np.float64),
                    library=library))
    _write_pickle(cache, out)
    return out
