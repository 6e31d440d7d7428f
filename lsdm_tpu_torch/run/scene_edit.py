"""Language-driven scene editing evaluation: the port's ``scene_edit``.

Counterpart of ``lsdm_tpu/run/scene_edit.py`` (reference
``run/scene_edit.py``), with the same CLI and output contract.  Three edit
types as masks over the ground truth (reference ``:35-56``):

  * ``obj_mod``   full regeneration (zero mask);
  * ``obj_dis``   displacement: keep the ground-truth shape, move it to
                  the predicted centroid (``:315-318``);
  * ``shape_alt`` keep the bottom-z quartile, regenerate the rest
                  (``:41-47,320``).

A keyword table maps prompt phrases to replacement scene objects
(``:59-98``); a hit replaces the target by that object, aligned to the
original target with multi-start ICP (``ops/icp.py``, all tries as one
batch), and adds the ICP statistics to ``results.txt``.

    python -m lsdm_tpu_torch.run.scene_edit DATA_DIR --objs_data_dir OBJS \\
        [--edit_type obj_mod|obj_dis|shape_alt] [--load_model model.pt] \\
        [--output_dir edit_output] [--device cuda]

Sampling is the JAX CLI's: the composed loop with the model's default
``ball_impl`` (on CUDA the selection kernels K1, K2, K3).  ``--device``
defaults to ``cuda`` and there is no silent CPU run: without a GPU the CLI
raises unless ``--device cpu`` is given.  Without ``--load_model`` the
weights are seeded (seed 0), as ``test_sdm`` seeds them; the text encoder
is HASH (CLIP is not ported).  The draws (ICP rotations, initial image,
per-step noise) come from one ``torch.Generator`` on the device, seeded
with ``--seed``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Optional, Sequence

import numpy as np
import torch

from lsdm_tpu_torch.run import jax_flags

# phrase -> (scene object path fragment, proxd category)  (reference :61-84;
# copied from lsdm_tpu/run/scene_edit.py)
EDIT_KEYWORDS = {
    "rectangle table": ("BasementSittingBooth/table_0", 2),
    "round table": ("MPH8/table_1", 2),
    "square table": ("N0SittingBooth/table_0", 2),
    "two seater sofa": ("MPH8/sofa_0", 4),
    "single bed": ("MPH8/bed_0", 5),
    "meeting table": ("MPH1Library/table_0", 2),
    "eames chair": ("MPH1Library/chair_3", 1),
    "office chair": ("MPH11/chair_0", 1),
    "side cabinet": ("MPH11/cabinet_0", 3),
    "file cabinet": ("MPH11/shelving_0", 3),
    "chest of drawers": ("MPH112/chest_of_drawers_1", 6),
    "double bed": ("MPH112/bed_0", 5),
    "sofa stool": ("N0Sofa/sofa_0", 4),
    "cafe table": ("N0Sofa/table_0", 2),
    "one seater sofa": ("N0Sofa/sofa_2", 4),
    "wall table": ("N3Library/furniture_0", 2),
    "desk": ("N3Office/table_0", 2),
    "monitor": ("N3Office/tv_monitor_0", 8),
    "accent chair": ("N3OpenArea/chair_2", 1),
    "accent table": ("N3OpenArea/table_0", 2),
    "recliner": ("MPH1Library/chair_3", 1),
    "dining chair": ("N0SittingBooth/seating_0", 1),
}


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("data_dir")
    ap.add_argument("--load_model", default=None,
                    help="a reference torch .pt checkpoint")
    ap.add_argument("--objs_data_dir", default="data/protext/objs")
    ap.add_argument("--output_dir", default="edit_output")
    ap.add_argument("--edit_type", default="obj_mod",
                    choices=["obj_mod", "obj_dis", "shape_alt"])
    ap.add_argument("--datatype", default="proxd", choices=["proxd", "humanise"])
    ap.add_argument("--diffusion_steps", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--icp_tries", type=int, default=64)
    ap.add_argument("--text_encoder", default="auto",
                    choices=["auto", "CLIP", "BERT", "HASH"],
                    help="'auto' = CLIP when a BPE merges source exists, else "
                         "HASH")
    ap.add_argument("--pcd_points", type=int, default=None,
                    help="override the cloud size (tiny smoke runs)")
    ap.add_argument("--bpe_path", default=None,
                    help="CLIP BPE merges file or directory (default: "
                         "$LSDM_TPU_CLIP_BPE, the vendored asset, the HF cache)")
    jax_flags.add_device(ap)
    return ap.parse_args(argv)


def edit_mask(gt: np.ndarray, edit_type: str) -> np.ndarray:
    """1 where the ground truth (1, N, 3) is kept (reference :35-56): nothing
    for obj_mod and obj_dis, the bottom-z quartile for shape_alt."""
    if edit_type in ("obj_mod", "obj_dis"):
        return np.zeros_like(gt)
    idx = np.argsort(gt[0, :, 2])[:gt.shape[1] // 4]
    m = np.zeros_like(gt)
    m[:, idx, :] = 1
    return m


def prompt_phrases(text: str):
    """The phrases searched in EDIT_KEYWORDS (reference :269-278): one, two
    and three words from the prompt's third word on."""
    tokens = text.split(" ")[2:5] + ["", "", ""]
    return [p.strip() for p in (tokens[0], f"{tokens[0]} {tokens[1]}",
                                f"{tokens[0]} {tokens[1]} {tokens[2]}")]


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the evaluation; returns the final metrics (and the mean ICP
    statistics when a keyword hit)."""
    args = parse_args(argv)
    if args.load_model and not args.load_model.endswith(".pt"):
        raise SystemExit(f"--load_model {args.load_model}: only reference "
                         "torch .pt checkpoints load into the port (a flax "
                         ".ckpt needs the JAX package's scene_edit)")
    dev = jax_flags.device(args, "scene_edit")

    from lsdm_tpu_torch import config as cfg_lib
    from lsdm_tpu_torch.checkpoint import load_torch_checkpoint
    from lsdm_tpu_torch.data.dataset import DataLoader, Humanise, ProxDatasetTxt
    from lsdm_tpu_torch.diffusion.schedule import make_schedule
    from lsdm_tpu_torch.models.sampling import sample_sdm
    from lsdm_tpu_torch.models.sdm import SceneDiffusionModel
    from lsdm_tpu_torch.models.text import TextEncoder, resolve_text_encoder
    from lsdm_tpu_torch.ops.icp import random_restart_icp, transform_points
    from lsdm_tpu_torch.ops.metrics import emd, fscore, topk_accuracy
    from lsdm_tpu_torch.ops.pointcloud import chamfer_distance
    from lsdm_tpu_torch.weights import init_weights

    model_cfg = (cfg_lib.sdm_proxd() if args.datatype == "proxd"
                 else cfg_lib.sdm_humanise())
    if args.pcd_points:
        model_cfg = dataclasses.replace(
            model_cfg, pcd_points=args.pcd_points,
            vert_dims=min(model_cfg.vert_dims, args.pcd_points))
    ds_cls = ProxDatasetTxt if args.datatype == "proxd" else Humanise
    ds = ds_cls(args.data_dir, objs_data_dir=args.objs_data_dir,
                max_cats=model_cfg.max_cats, pnt_size=model_cfg.pcd_points)
    loader = DataLoader(ds, 1, shuffle=False)
    schedule = make_schedule("cosine", args.diffusion_steps, device=dev)
    text_encoder = TextEncoder(resolve_text_encoder(args.text_encoder, args.bpe_path),
                               dim=model_cfg.clip_dim, bpe_path=args.bpe_path,
                               device=dev)
    model = init_weights(SceneDiffusionModel(model_cfg), 0)
    if args.load_model:
        print(f"loaded torch checkpoint {args.load_model}: "
              f"{load_torch_checkpoint(args.load_model, model)}")
    model = model.to(dev).eval()
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def replacement(keyword: str, origin: np.ndarray):
        """(reference :59-98): the keyword's object, ICP-aligned to the
        original target, its category, and the ICP result; or None."""
        if keyword not in EDIT_KEYWORDS:
            return None
        handle, cat = EDIT_KEYWORDS[keyword]
        path = os.path.join(args.objs_data_dir, handle + ".npy")
        if not os.path.exists(path):
            return None
        obj = put(np.load(path).astype(np.float32))
        res = random_restart_icp(obj, put(origin[0]), generator=gen,
                                 n_tries=args.icp_tries, threshold=0.2)
        aligned = transform_points(obj, res.transformation).cpu().numpy()[None]
        target_cat = np.zeros((1, model_cfg.max_cats), np.float32)
        target_cat[0, cat] = 1
        return aligned, target_cat, res

    for sub in ("predictions", "guiding_points"):
        os.makedirs(os.path.join(args.output_dir, sub), exist_ok=True)
    print(f"scene_edit: {len(ds)} sequences on {dev}, edit={args.edit_type}, "
          f"T={schedule.num_timesteps}")
    chs, emds, f1s, accs, top3s, lines = [], [], [], [], [], []
    fits, rmses, corrs = [], [], []
    for batch in loader:
        target = np.asarray(batch.target_verts, np.float32)
        target_cat = np.asarray(batch.target_cat)
        x_mask = edit_mask(target, args.edit_type)
        for phrase in prompt_phrases(batch.text[0]):
            hit = replacement(phrase, target)
            if hit is not None:
                target, target_cat, reg = hit
                fits.append(float(reg.fitness))
                rmses.append(float(reg.inlier_rmse))
                corrs.append(int(reg.n_correspondences))
                break

        sample, last = sample_sdm(
            model, schedule, put(batch.mask), put(batch.given_objs),
            put(batch.given_cats), put(text_encoder.encode(batch.text)),
            generator=gen, clip_denoised=False)
        pred = sample.cpu().numpy()
        if args.edit_type == "obj_dis":
            pred = target - target[0].mean(0) + pred[0].mean(0)
        else:
            pred = x_mask * target + (1 - x_mask) * pred
        pred = pred.astype(np.float32)

        p, g = put(pred), put(target)
        chs.append(float(chamfer_distance(p, g)))
        emds.append(emd(p, g))
        f1s.append(float(fscore(p[0], g[0], 0.1)[0]))
        tcat = put(target_cat).argmax(dim=1)
        probs = last.cat[:, 0, :]
        (top1,) = topk_accuracy(probs, tcat, (1,))
        (top3,) = topk_accuracy(probs, tcat, (3,))
        accs.append(float(top1) / 100)
        top3s.append(float(top3) / 100)

        seq = batch.seq_names[0]
        lines.append(f"Chamfer distance for seq {seq}: {chs[-1]:.4f}")
        np.save(os.path.join(args.output_dir, "predictions", seq + ".npy"), pred[0])
        np.save(os.path.join(args.output_dir, "guiding_points", seq + ".npy"),
                last.guiding[0].cpu().numpy().astype(np.float32))

    final = {"cfd": float(np.mean(chs)), "emd": float(np.mean(emds)),
             "f1": float(np.mean(f1s)), "acc": float(np.mean(accs)),
             "top3": float(np.mean(top3s))}
    if fits:
        final.update(fitness=float(np.mean(fits)), mse=float(np.mean(rmses)),
                     corr_set=float(np.mean(corrs)))
    with open(os.path.join(args.output_dir, "results.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
        f.write(f"Final Chamfer distance: {final['cfd']:.4f}\n")
        f.write(f"Final EMD: {final['emd']:.4f}\n")
        f.write(f"Final F1 score: {final['f1']:.4f}\n")
        f.write(f"Category accuracy: {final['acc']:.4f}\n")
        f.write(f"Top 3 accuracy: {final['top3']:.4f}\n")
        if fits:
            f.write(f"Fitness: {final['fitness']:.4f}\n")
            f.write(f"MSE: {final['mse']:.4f}\n")
            f.write(f"Corr set: {final['corr_set']:.4f}\n")
    print(f"edit={args.edit_type} CFD {final['cfd']:.4f} | EMD {final['emd']:.4f} "
          f"| F1 {final['f1']:.4f}")
    return final


if __name__ == "__main__":
    main()
