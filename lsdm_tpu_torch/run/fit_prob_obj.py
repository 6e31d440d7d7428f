"""Probabilistic-contact object fitting (reference ``fit_prob_obj.py``).

Counterpart of ``lsdm_tpu/run/fit_prob_obj.py``, with its arguments; the
fitting runs on ``--device`` (cuda by default; without a GPU it refuses
unless ``--device cpu`` is given; the JAX flag ``--platform`` is refused).

The upstream script is an abandoned 101-line fragment: it uses ``np`` /
``torch`` / ``json`` / ``config`` without importing them, reads
``args.contact_labels_path`` after declaring ``contact_probs_path``
(``fit_prob_obj.py:14,25``), argmaxes ``contact_labels`` before the name
exists (``:27``), and truncates mid-flow after the floor estimate
(``:101``).  SURVEY.md §2.6 documents it as broken upstream.  This
runner is a working reconstruction of its evident intent — fitting
driven by per-vertex contact-class *probabilities* with ``sample_count``
label draws, instead of the hard argmax labels ``fit_best_obj`` uses:

  vertices (T, V, 3) + contact_probs (T, V, 8)
    -> ``sample_count`` per-vertex label draws (draw 0 is the argmax/MAP
       assignment, the deterministic anchor; draws 1.. are categorical
       samples via the Gumbel trick)
    -> per draw: majority voting, per-class DBSCAN clustering, and the
       shared grid-search + Adam fitting (``lsdm_tpu_torch/fitting/fit_objects.py``),
       written under ``<output_dir>/sample_<s>/``
    -> ``prob_fit.json``: per-draw losses, the best draw, and the
       cross-draw spread of fitted-object centers — the placement
       uncertainty the probabilistic formulation exists to expose.

Per-sequence hyper-parameters resolve exactly like the fragment's
``config.params[sequence_name]`` lookup with a default fallback
(``fit_prob_obj.py:45-50``): ``FITTING_PARAMS[sequence_name]`` ->
``FITTING_PARAMS["default"]``.  The human SDF and floor height are
shared across draws (the human surface does not depend on the labels;
floor uses the MAP labels, matching the fragment's "most probable
contact labels for floor estimation" comment, ``fit_prob_obj.py:95``).

Usage (positional args mirror the fragment, ``fit_prob_obj.py:9-17``):
  python -m lsdm_tpu_torch.run.fit_prob_obj SEQ verts.npy probs.npy 4 \
      --obj_lib data/obj_library --output_dir fitting_results
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence

from lsdm_tpu_torch.run import _fitting, jax_flags


def sample_label_draws(probs, sample_count: int, seed: int = 0):
    """(T, V, C) probabilities -> (sample_count, T, V) int32 label draws.

    Draw 0 is the MAP assignment (argmax); draws 1.. are independent
    categorical samples via argmax(log p + Gumbel noise) — one
    vectorized op per draw, no per-vertex Python loop.  All-non-negative
    inputs are treated as (possibly unnormalized) probabilities and
    normalized by their row sums — NOT softmaxed, which would distort
    e.g. fp16-exported probability rows that sum to 0.999;
    an all-zero row in that regime is an error.  The softmax branch is
    reserved for inputs containing negatives, i.e. logits.
    """
    import numpy as np

    probs = np.asarray(probs, np.float64)
    if (probs >= 0).all():
        row = probs.sum(-1, keepdims=True)
        if (row <= 0).any():
            raise ValueError(
                "contact_probs has all-zero probability rows (e.g. zero "
                "padding); pad with a valid distribution or pass logits"
            )
        probs = probs / row
    else:
        z = probs - probs.max(-1, keepdims=True)
        e = np.exp(z)
        probs = e / e.sum(-1, keepdims=True)
    logp = np.log(np.maximum(probs, 1e-30))
    draws = [probs.argmax(-1).astype(np.int32)]
    for s in range(1, sample_count):
        g = np.random.default_rng(seed + s).gumbel(size=probs.shape)
        draws.append((logp + g).argmax(-1).astype(np.int32))
    return np.stack(draws[:max(sample_count, 1)])


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the fitting; returns the ``prob_fit.json`` summary."""
    ap = argparse.ArgumentParser()
    ap.add_argument("sequence_name")
    ap.add_argument("vertices_path", help="(T, V, 3) human vertex .npy")
    ap.add_argument("contact_probs_path",
                    help="(T, V, 8) per-vertex contact-class probabilities "
                         "(or logits) .npy")
    ap.add_argument("sample_count", type=int,
                    help="number of label draws (draw 0 is the MAP labels)")
    ap.add_argument("--obj_lib", required=True)
    ap.add_argument("--output_dir", default="fitting_results")
    ap.add_argument("--faces_path", default=None)
    ap.add_argument("--sdf_dim", type=int, default=256)
    ap.add_argument("--down_sample", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    jax_flags.add_device(ap)
    args = ap.parse_args(argv)
    dev = jax_flags.device(args, "fit_prob_obj")

    import numpy as np

    from lsdm_tpu_torch.fitting.config import FITTING_PARAMS
    from lsdm_tpu_torch.fitting.fit_objects import (
        cluster_contact_points, fit_contact_clusters, vote_contact_points,
    )
    from lsdm_tpu_torch.fitting.meshio import read_human_mesh_sequence
    from lsdm_tpu_torch.fitting.sdf import cached_sdf
    from lsdm_tpu_torch.ops.geometry import estimate_floor_height

    verts_seq, faces = read_human_mesh_sequence(
        args.vertices_path, args.faces_path, args.down_sample
    )
    probs = np.load(args.contact_probs_path).astype(np.float32)
    if probs.ndim == 2:
        probs = probs[None]
    # contact predictions may be at full-sequence or already-downsampled
    # frame rate (the fragment paired labels[f] with vertices[f * 8],
    # fit_prob_obj.py:35-36); align to the downsampled vertex frames
    if probs.shape[0] != verts_seq.shape[0]:
        probs = probs[:: args.down_sample]
    n = min(probs.shape[0], verts_seq.shape[0])
    probs, verts_used = probs[:n], verts_seq[:n]

    params = FITTING_PARAMS.get(args.sequence_name, FITTING_PARAMS["default"])

    surface = _fitting.human_surface(verts_seq, faces)
    os.makedirs(args.output_dir, exist_ok=True)
    sdf, centroid, extents = cached_sdf(
        os.path.join(args.output_dir, "human_sdf.npz"), surface, args.sdf_dim
    )

    draws = sample_label_draws(probs, args.sample_count, args.seed)
    # floor from the MAP labels: floor-contact vertices (class 2) when any
    # exist, else the full surface
    floor_mask = draws[0] == 2
    floor = estimate_floor_height(
        verts_used.reshape(-1, 3),
        floor_mask.reshape(-1) if floor_mask.any() else None,
    )
    print(f"floor height: {floor:.3f}; {len(draws)} label draw(s)")

    per_sample = []
    for s, labels in enumerate(draws):
        voted = vote_contact_points(verts_used, labels)
        clusters_by_class = {
            cid: cluster_contact_points(pts, cid) for cid, pts in voted.items()
        }
        clusters_by_class = {k: v for k, v in clusters_by_class.items() if v}
        out_s = os.path.join(args.output_dir, f"sample_{s:02d}")
        results = fit_contact_clusters(
            clusters_by_class, args.obj_lib, sdf, centroid, extents, floor,
            os.path.join(out_s, "fit_best_obj"), params, device=dev,
        )
        fits = [
            {"class": r["class"], "cluster": r["cluster"],
             "obj_id": r["obj_id"], "loss": r["loss"],
             "center": np.asarray(r["points"]).mean(0).tolist()}
            for r in results
        ]
        total = float(sum(f["loss"] for f in fits)) if fits else float("inf")
        per_sample.append({"sample": s, "total_loss": total, "fits": fits})
        print(f"sample {s}: {len(fits)} fit(s), total loss "
              f"{total if fits else float('nan'):.4f}")

    # cross-draw placement spread per class: std of fitted centers — the
    # uncertainty signal hard-label fitting cannot produce
    spread = {}
    by_class = {}
    for ps in per_sample:
        for f in ps["fits"]:
            by_class.setdefault(f["class"], []).append(f["center"])
    for cname, centers in by_class.items():
        c = np.asarray(centers, np.float64)
        spread[cname] = {
            "n_placements": len(c),
            "center_std": c.std(0).tolist() if len(c) > 1 else [0.0, 0.0, 0.0],
        }

    fitted = [p for p in per_sample if p["fits"]]
    best = min(fitted, key=lambda p: p["total_loss"])["sample"] if fitted else None
    summary = {
        "sequence": args.sequence_name,
        "sample_count": int(args.sample_count),
        "best_sample": best,
        "samples": per_sample,
        "placement_spread": spread,
    }
    with open(os.path.join(args.output_dir, "prob_fit.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(f"best sample: {best}; summary -> "
          f"{os.path.join(args.output_dir, 'prob_fit.json')}")
    return summary


if __name__ == "__main__":
    main()
