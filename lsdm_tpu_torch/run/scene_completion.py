"""Add non-contact objects to a fitted scene (reference
``scene_completion.py``).

Counterpart of ``lsdm_tpu/run/scene_completion.py``.  Each iteration
(reference ``:83-272``): the boxes of every fitted object and of every
8th human mesh span a square scene; ATISS's ``distribution_classes`` over
the fitted classes gives the next object's class; a 256 x 256 occupancy
grid of the boxes' footprints, a free cell that fits a candidate mesh's
footprint; the mesh is floor-aligned and written as
``fit_best_obj/<class>/<n>/<mesh>/opt_best.obj`` beside a
``best_obj_id.json`` tagged ``no_contact`` (a rerun first removes those).
Every draw (the class, the candidates, the cells) comes from
``np.random.RandomState(--seed)``, as in JAX, so the placements compare.
``--path_to_model`` takes an ATISS ``.pt`` (the simple extractor, 23
classes); without one the weights are seeded with ``--seed``.  The model
runs on ``--device`` (cuda unless ``cpu`` is asked for).

    python -m lsdm_tpu_torch.run.scene_completion --fitting_results_path R \\
        --obj_dataset_path OBJS [--path_to_model M.pt] [--num_iter 3]
"""

from __future__ import annotations

import argparse
import json
import shutil
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

from lsdm_tpu_torch.run import jax_flags

# 3D-FUTURE-style class vocabulary (reference ``scene_completion.py:8-39``)
OBJECT_TYPES = [
    "armchair", "bookshelf", "cabinet", "ceiling_lamp", "chair",
    "children_cabinet", "coffee_table", "desk", "double_bed", "dressing_chair",
    "dressing_table", "kids_bed", "nightstand", "pendant_lamp", "shelf",
    "single_bed", "sofa", "stool", "table", "tv_stand", "wardrobe", "other",
    "none",
]
GRID_SIZE = 256


def get_grid_index(scene_center, half_len, grid_size, point):
    top_left = np.array([scene_center[0] - half_len, scene_center[1] - half_len])
    cell = half_len * 2 / grid_size
    return np.floor((np.asarray(point) - top_left) / cell).astype(int)


def get_cell_center(scene_center, scene_length, grid_size, idx):
    """World-space centre of grid cell (i, j); the JAX package's repair of
    the reference's grid-local coordinates (``scene_completion.py:49-51``)."""
    cell = scene_length / grid_size
    top_left = np.array([scene_center[0] - scene_length / 2,
                         scene_center[1] - scene_length / 2])
    return top_left + np.array([(idx[0] + 0.5) * cell, (idx[1] + 0.5) * cell])


def area_occupied(occ, tl, br):
    return occ[tl[0]:br[0] + 1, tl[1]:br[1] + 1].sum() != 0


def aabb_of_obj(path: str):
    from lsdm_tpu_torch.fitting.meshio import load_mesh

    verts, _ = load_mesh(path)
    lo, hi = verts.min(0), verts.max(0)
    return (lo + hi) / 2, (hi - lo) / 2  # centre, half extent


def collect_fitted_bboxes(fit_dir: Path):
    boxes, classes = [], []
    for class_dir in sorted(fit_dir.iterdir()):
        if not class_dir.is_dir():
            continue
        for obj_dir in sorted(class_dir.iterdir()):
            meta = obj_dir / "best_obj_id.json"
            if not meta.exists():
                continue
            best = json.loads(meta.read_text())
            mesh = obj_dir / best["best_obj_id"] / "opt_best.obj"
            if not mesh.exists():
                cand = list(obj_dir.glob("*/opt_best.obj")) + list(
                    obj_dir.glob("opt_best.obj"))
                if not cand:
                    continue
                mesh = cand[0]
            boxes.append(aabb_of_obj(str(mesh)))
            classes.append(class_dir.name)
    return boxes, classes


def _drop_added(fit_dir: Path) -> None:
    """Remove the non-contact objects of an earlier run (reference :93-101)."""
    for class_dir in list(fit_dir.iterdir()) if fit_dir.exists() else []:
        if not class_dir.is_dir():
            continue
        for obj_dir in list(class_dir.iterdir()):
            meta = obj_dir / "best_obj_id.json"
            if meta.exists() and json.loads(meta.read_text()).get("no_contact"):
                shutil.rmtree(obj_dir)
        if not any(class_dir.iterdir()):
            class_dir.rmdir()


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--fitting_results_path", required=True)
    ap.add_argument("--obj_dataset_path", required=True)
    ap.add_argument("--path_to_model", default=None, help="ATISS .pt")
    ap.add_argument("--num_iter", type=int, default=3)
    ap.add_argument("--spare_length", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    jax_flags.add_device(ap)
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> List[str]:
    """Run; returns the meshes written."""
    args = parse_args(argv)
    if args.path_to_model and not args.path_to_model.endswith(".pt"):
        raise SystemExit(f"--path_to_model {args.path_to_model}: only torch .pt "
                         "checkpoints load into the port (a flax .ckpt needs the "
                         "JAX package's scene_completion)")
    dev = jax_flags.device(args, "scene_completion")
    import torch

    from lsdm_tpu_torch.checkpoint import load_atiss_checkpoint
    from lsdm_tpu_torch.fitting.fit_objects import align_to_floor
    from lsdm_tpu_torch.fitting.meshio import write_obj
    from lsdm_tpu_torch.models.atiss import AutoregressiveTransformer
    from lsdm_tpu_torch.ops.spiral import load_obj
    from lsdm_tpu_torch.weights import init_weights

    rng = np.random.RandomState(args.seed)
    fit_dir = Path(args.fitting_results_path) / "fit_best_obj"
    obj_dataset = Path(args.obj_dataset_path)
    _drop_added(fit_dir)

    C = len(OBJECT_TYPES)
    model = init_weights(AutoregressiveTransformer(C), args.seed)
    if args.path_to_model:
        load_atiss_checkpoint(args.path_to_model, model)
    model = model.to(dev).eval()

    def class_probs(classes) -> np.ndarray:
        n = max(len(classes), 1)
        cl = torch.zeros(1, n, C)
        for i, name in enumerate(classes):
            if name in OBJECT_TYPES:
                cl[0, i, OBJECT_TYPES.index(name)] = 1
        boxes = {"class_labels": cl, "translations": torch.zeros(1, n, 3),
                 "sizes": torch.zeros(1, n, 3), "angles": torch.zeros(1, n, 1),
                 "room_layout": torch.ones(1, 1, 64, 64)}
        with torch.no_grad():
            probs = model.distribution_classes(
                {k: v.to(dev) for k, v in boxes.items()})[0, 0].cpu().numpy()
        return probs / probs.sum()

    # human boxes every 8th frame (reference get_human_list :72-80)
    human_boxes = []
    human_dir = Path(args.fitting_results_path) / "human" / "mesh"
    if human_dir.exists():
        for p in sorted(human_dir.iterdir())[::8]:
            if p.suffix in (".obj", ".ply"):
                human_boxes.append(aabb_of_obj(str(p)))

    obj_boxes, _ = collect_fitted_bboxes(fit_dir) if fit_dir.exists() else ([], [])
    total = obj_boxes + human_boxes
    if not total:
        print("nothing fitted yet; nothing to complete")
        return []
    scene_center = np.mean([c for c, _ in total], axis=0)
    scene_length = max(
        2 * (np.abs(c - scene_center)[:2].max() + h[:2].max()) for c, h in total
    ) + args.spare_length

    written = []
    for it in range(args.num_iter):
        obj_boxes, classes = collect_fitted_bboxes(fit_dir)
        probs = class_probs(classes)
        occ = np.zeros((GRID_SIZE, GRID_SIZE))
        for c, h in obj_boxes + human_boxes:
            tl = get_grid_index(scene_center, scene_length / 2, GRID_SIZE, (c - h)[:2])
            br = get_grid_index(scene_center, scene_length / 2, GRID_SIZE, (c + h)[:2])
            occ[max(tl[0], 0):br[0] + 1, max(tl[1], 0):br[1] + 1] = 1

        # a class with candidates on disk (reference :201-208)
        sampled = None
        for _ in range(100):
            k = rng.choice(C, p=probs)
            if (obj_dataset / OBJECT_TYPES[k]).exists():
                sampled = OBJECT_TYPES[k]
                break
        if sampled is None:
            print("no sampleable class has candidates on disk")
            continue
        print(f"iter {it}: sampled class {sampled}")

        candidates = sorted((obj_dataset / sampled).glob("**/*.obj"))
        if len(candidates) > 3:
            candidates = list(rng.choice(candidates, size=3, replace=False))
        added = None
        for cand in candidates:
            verts, faces = load_obj(str(cand))
            half = (verts.max(0) - verts.min(0))[:2] / 2
            free = np.argwhere(occ == 0)
            rng.shuffle(free)
            for (i, j) in free[:2000]:
                cc = get_cell_center(scene_center, scene_length, GRID_SIZE, (i, j))
                tl = get_grid_index(scene_center, scene_length / 2, GRID_SIZE, cc - half)
                br = get_grid_index(scene_center, scene_length / 2, GRID_SIZE, cc + half)
                if (tl < 0).any() or (br >= GRID_SIZE).any() or area_occupied(occ, tl, br):
                    continue
                v = align_to_floor(verts, 0.0)
                center = v.mean(0)
                target = np.array([cc[0], cc[1], center[2]])
                v = v - center + target
                save_dir = fit_dir / sampled
                save_dir.mkdir(parents=True, exist_ok=True)
                slot = save_dir / str(len(list(save_dir.iterdir())))
                mesh_dir = slot / cand.stem
                mesh_dir.mkdir(parents=True)
                write_obj(str(mesh_dir / "opt_best.obj"), v, faces)
                (slot / "best_obj_id.json").write_text(
                    json.dumps({"best_obj_id": cand.stem, "no_contact": True}))
                print(f"placed {cand.stem} at {target[:2]}")
                added = str(mesh_dir / "opt_best.obj")
                break
            if added:
                break
        if added:
            written.append(added)
        else:
            print(f"failed to place any {sampled} (scene too crowded)")
    return written


if __name__ == "__main__":
    main()
