"""Synthetic dataset generator matching the PRO-teXt on-disk contract.

A copy of ``lsdm_tpu/data/synthetic.py:generate`` (the JAX package's
cannot be imported without jax), so that ``chip_smoke.py`` and the tests
can write a dataset with the port alone; for one seed it writes the same
files (``tests/test_torch_cli.py``).  Objects are seeded blobby clusters
placed in the scene, the "human" an ellipsoid cloud, prompts name the
target category.

Usage:  python -m lsdm_tpu_torch.data.synthetic --out DIR --scenes 2 --seqs 8
"""

from __future__ import annotations

import argparse
import os
from typing import List

import numpy as np

PROXD_OBJ_NAMES = [
    "chair", "table", "cabinet", "sofa", "bed", "chest_of_drawers",
    "stool", "tv_monitor", "lighting", "shelving", "seating", "furniture",
]
HUMANISE_OBJ_NAMES = [
    "bed", "sofa", "table", "door", "desk", "refrigerator", "chair",
    "counter", "bookshelf", "cabinet",
]

PROMPTS = [
    "place a {} next to the person",
    "put a {} in front of the human",
    "add a {} behind the person",
    "there should be a {} beside the human",
]


def _blob(rng: np.random.RandomState, n: int, center, scale) -> np.ndarray:
    pts = rng.randn(n, 3).astype(np.float32) * np.asarray(scale, np.float32)
    return pts + np.asarray(center, np.float32)


def generate(
    out_dir: str,
    datatype: str = "proxd",
    n_scenes: int = 2,
    n_seqs: int = 8,
    n_objs_per_scene: int = 6,
    pnt_size: int = 1024,
    seed: int = 0,
    split: str = "train",
) -> str:
    rng = np.random.RandomState(seed)
    names = PROXD_OBJ_NAMES if datatype == "proxd" else HUMANISE_OBJ_NAMES
    data_dir = os.path.join(
        out_dir, f"proxd_{split}" if datatype == "proxd" else split
    )
    objs_dir = os.path.join(out_dir, "objs")
    os.makedirs(os.path.join(data_dir, "context"), exist_ok=True)
    os.makedirs(os.path.join(data_dir, "reduced_vertices"), exist_ok=True)

    scenes: List[str] = []
    scene_objs: dict = {}
    for s in range(n_scenes):
        if datatype == "proxd":
            scene = f"Scene{s:02d}"
        else:
            scene = f"scene{s:04d}_00"  # seq prefix must be 9 chars + _00
        scenes.append(scene)
        os.makedirs(os.path.join(objs_dir, scene), exist_ok=True)
        scene_objs[scene] = []
        for k in range(n_objs_per_scene):
            name = names[rng.randint(len(names))]
            obj = f"{name}_{k}"
            center = rng.uniform(-2, 2, 3)
            center[2] = abs(center[2]) * 0.3
            cloud = _blob(rng, pnt_size, center, rng.uniform(0.1, 0.5, 3))
            np.save(os.path.join(objs_dir, scene, obj + ".npy"), cloud)
            scene_objs[scene].append(obj)

    for i in range(n_seqs):
        scene = scenes[i % n_scenes]
        if datatype == "proxd":
            seq = f"{scene}_{i:05d}_01"
        else:
            seq = f"{scene[:9]}_{i:05d}"
        human = _blob(rng, pnt_size, [0, 0, 0.8], [0.3, 0.3, 0.8])
        np.save(os.path.join(data_dir, "reduced_vertices", seq + ".npy"), human)
        objs = scene_objs[scene]
        k_given = int(rng.randint(1, min(6, len(objs))))
        picked = list(rng.choice(len(objs), size=k_given + 1, replace=False))
        given = [objs[j] for j in picked[:-1]]
        target = objs[picked[-1]]
        target_name = target.split("_")[0]
        prompt = PROMPTS[i % len(PROMPTS)].format(target_name.replace("_", " "))
        with open(os.path.join(data_dir, "context", seq + ".txt"), "w") as f:
            f.write(prompt + "\n")
            f.write(" ".join(given) + "\n")
            f.write(target + "\n")
    return data_dir


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--datatype", default="proxd", choices=["proxd", "humanise"])
    ap.add_argument("--scenes", type=int, default=2)
    ap.add_argument("--seqs", type=int, default=8)
    ap.add_argument("--pnt_size", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--split", default="train")
    a = ap.parse_args()
    d = generate(
        a.out, a.datatype, a.scenes, a.seqs, pnt_size=a.pnt_size, seed=a.seed,
        split=a.split,
    )
    print(f"wrote synthetic {a.datatype} dataset to {d}")


if __name__ == "__main__":
    main()
