"""Evaluate the SceneDiffusionModel: the port's ``test_sdm`` entry point.

Counterpart of ``lsdm_tpu/run/test_sdm.py`` (reference ``run/test_sdm.py``).
Samples every sequence of a test split, computes CFD (chamfer), exact EMD,
F1@0.1 and category top-1/top-3 accuracy, and writes ``results.txt``,
``predictions/<seq>.npy`` and ``guiding_points/<seq>.npy`` in the JAX
CLI's (and the reference's) output contract.

    python -m lsdm_tpu_torch.run.test_sdm DATA_DIR --objs_data_dir OBJS \\
        [--load_model model.pt] [--output_dir test_output] [--device cuda]

On CUDA, ``--ball_impl auto`` and ``--fused_step auto`` resolve to the
fused encode and the whole-loop chain kernel (``models/sampling.py:
resolve_fast_path``).  ``--fused_step step`` (or a bare ``--fused_step``)
samples with the one-step kernel K9, called once per step from the host.  ``--device`` defaults to ``cuda`` and there is no
silent CPU run: without a GPU the CLI raises unless ``--device cpu`` is
given.  Without ``--load_model`` the weights are seeded (seed 0), as the
JAX CLI initialises them.  ``--text_encoder auto`` runs the CLIP tower on
the device when a BPE merges source is found (``--bpe_path``,
``$LSDM_TPU_CLIP_BPE``, the vendored asset, the HF cache), with the
weights of ``--clip_weights`` or seeded ones, and the HASH encoder
otherwise; with ``--load_model``, CLIP or BERT without their assets
refuse to run.  The draws (initial image and per-step noise)
come from one ``torch.Generator`` on the device, seeded with ``--seed``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from lsdm_tpu_torch.run import jax_flags


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("data_dir")
    ap.add_argument("--load_model", default=None,
                    help="a reference torch .pt checkpoint")
    ap.add_argument("--objs_data_dir", default=None)
    ap.add_argument("--output_dir", default="test_output")
    ap.add_argument("--datatype", default="proxd", choices=["proxd", "humanise"])
    ap.add_argument("--batch_size", type=int, default=4)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--use_ddim", action="store_true")
    ap.add_argument("--timestep_respacing", default="")
    ap.add_argument("--diffusion_steps", type=int, default=1000)
    ap.add_argument("--text_encoder", default="auto",
                    choices=["auto", "CLIP", "BERT", "HASH"],
                    help="'auto' = CLIP when a BPE merges source exists, else "
                         "HASH")
    ap.add_argument("--pcd_points", type=int, default=None,
                    help="override the cloud size (tiny smoke runs)")
    ap.add_argument("--fused_step", nargs="?", const="step", default="auto",
                    choices=["auto", "step", "chain", "none"],
                    help="'step' (also a bare --fused_step) = one kernel "
                         "launch per step; 'chain' = the whole loop as one "
                         "kernel; 'none' = the composed loop; 'auto' = "
                         "'chain' on CUDA, the composed loop on the CPU")
    ap.add_argument("--cond_chunk", type=int, default=None,
                    help="encode the conditioning in batch chunks (memory cap)")
    ap.add_argument("--ball_impl", default="auto",
                    choices=["auto", "fused", "pallas", "topk"],
                    help="'auto' = 'fused' on CUDA (fused encode kernels), "
                         "the composed encode on the CPU")
    ap.add_argument("--gather_bwd", default="scatter",
                    help="JAX CLI flag: only 'scatter', the exact gather the "
                         "port runs, is taken")
    ap.add_argument("--bpe_path", default=None,
                    help="CLIP BPE merges file or directory (default: "
                         "$LSDM_TPU_CLIP_BPE, the vendored asset, the HF cache)")
    ap.add_argument("--clip_weights", default=None,
                    help="a torch CLIP text state dict (OpenAI or HF naming) "
                         "for --text_encoder CLIP")
    jax_flags.add_device(ap)
    return ap.parse_args(argv)


class Sampling(NamedTuple):
    """What an SDM sampling entry point builds from its flags."""

    model: torch.nn.Module
    schedule: object
    loader: object
    text_encoder: object
    fused_step: Optional[str]
    timestep_map: Optional[torch.Tensor]


def refuse_flax_checkpoint(args: argparse.Namespace, prog: str) -> None:
    """Stop unless ``--load_model`` is empty or a torch ``.pt`` file."""
    if args.load_model and not args.load_model.endswith(".pt"):
        raise SystemExit(f"--load_model {args.load_model}: only reference "
                         "torch .pt checkpoints load into the port (a flax "
                         f".ckpt needs the JAX package's {prog})")


def setup_sampling(args: argparse.Namespace, dev: torch.device) -> Sampling:
    """The model (seeded, or ``--load_model``), the test split's loader, the
    schedule and the text encoder for ``args``, on the fast path that
    ``resolve_fast_path`` gives on ``dev``.  Flags an entry point lacks
    take their defaults (``--pcd_points``, ``--ball_impl``,
    ``--fused_step``, ``--timestep_respacing``, the CLIP flags)."""
    from lsdm_tpu_torch import config as cfg_lib
    from lsdm_tpu_torch.checkpoint import load_torch_checkpoint
    from lsdm_tpu_torch.data.dataset import DataLoader, Humanise, ProxDatasetTxt
    from lsdm_tpu_torch.diffusion.schedule import make_schedule, spaced_schedule
    from lsdm_tpu_torch.models.sampling import resolve_fast_path
    from lsdm_tpu_torch.models.sdm import SceneDiffusionModel
    from lsdm_tpu_torch.models.text import TextEncoder, resolve_text_encoder
    from lsdm_tpu_torch.weights import clip_text_state_dict, init_weights

    def flag(name, default=None):
        return getattr(args, name, default)

    model_cfg = (cfg_lib.sdm_proxd() if args.datatype == "proxd"
                 else cfg_lib.sdm_humanise())
    if flag("pcd_points"):
        model_cfg = dataclasses.replace(
            model_cfg, pcd_points=args.pcd_points,
            vert_dims=min(model_cfg.vert_dims, args.pcd_points))
    ball_impl, fused_step = resolve_fast_path(flag("ball_impl", "auto"),
                                              flag("fused_step", "auto"), dev)
    model_cfg = dataclasses.replace(model_cfg, ball_impl=ball_impl)
    ds_cls = ProxDatasetTxt if args.datatype == "proxd" else Humanise
    objs_kw = {"objs_data_dir": args.objs_data_dir} if args.objs_data_dir else {}
    ds = ds_cls(args.data_dir, max_cats=model_cfg.max_cats,
                pnt_size=model_cfg.pcd_points, **objs_kw)
    loader = DataLoader(ds, args.batch_size, shuffle=False)

    respacing = flag("timestep_respacing", "")
    if respacing:
        schedule = spaced_schedule("cosine", args.diffusion_steps, respacing,
                                   device=dev)
    else:
        schedule = make_schedule("cosine", args.diffusion_steps, device=dev)

    clip_sd = None
    if flag("clip_weights"):
        sd = torch.load(args.clip_weights, map_location="cpu", weights_only=False)
        clip_sd = clip_text_state_dict(sd.get("state_dict", sd))
        print(f"converted CLIP text tower: {args.clip_weights}")
    encoder = resolve_text_encoder(args.text_encoder, flag("bpe_path"))
    text_encoder = TextEncoder(
        encoder, dim=model_cfg.clip_dim, state_dict=clip_sd,
        bpe_path=flag("bpe_path"), device=dev,
        # evaluating a checkpoint with a mismatched tokenizer silently
        # gives wrong numbers: refuse instead
        require_parity=bool(args.load_model) and encoder in ("CLIP", "BERT"))
    if args.load_model and encoder == "HASH":
        print("WARNING: evaluating a checkpoint with --text_encoder HASH; "
              "prompt embeddings will not match the reference CLIP tower. "
              "Use --text_encoder CLIP with --clip_weights (and a BPE merges "
              "source, auto-detected when available) for parity-grade numbers.")
    model = init_weights(SceneDiffusionModel(model_cfg), 0)
    if args.load_model:
        extra = load_torch_checkpoint(args.load_model, model)
        print(f"loaded torch checkpoint {args.load_model}: {extra}")
    model = model.to(dev).eval()
    print(f"{len(ds)} sequences on {dev}, text_encoder={encoder}, "
          f"ball_impl={ball_impl}, fused_step={fused_step}, "
          f"T={schedule.num_timesteps}")
    return Sampling(model, schedule, loader, text_encoder, fused_step,
                    schedule.timestep_map if respacing else None)


def sample_batch(s: Sampling, batch, generator: torch.Generator,
                 use_ddim: bool = False, cond_chunk: Optional[int] = None):
    """``sample_sdm`` over one loader batch on the model's device; returns
    (sample (B, N, 3), the last step's DenoiserOutput)."""
    from lsdm_tpu_torch.models.sampling import sample_sdm

    dev = next(s.model.parameters()).device

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return sample_sdm(
        s.model, s.schedule, put(batch.mask), put(batch.given_objs),
        put(batch.given_cats), put(s.text_encoder.encode(batch.text)),
        generator=generator, use_ddim=use_ddim, timestep_map=s.timestep_map,
        cond_chunk=cond_chunk, fused_step=s.fused_step)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the evaluation; returns the five final metrics."""
    args = parse_args(argv)
    if args.gather_bwd != "scatter":
        raise SystemExit(f"--gather_bwd {args.gather_bwd} is not ported: "
                         "one-hot matmul gathers are a TPU workaround "
                         "(ROADMAP.md, 'Not ported'); the port's gathers are "
                         "exact, as 'scatter'")
    refuse_flax_checkpoint(args, "test_sdm")
    dev = jax_flags.device(args, "test_sdm")

    from lsdm_tpu_torch.ops.metrics import emd, fscore, topk_accuracy
    from lsdm_tpu_torch.ops.pointcloud import chamfer_distance

    for sub in ("predictions", "guiding_points"):
        os.makedirs(os.path.join(args.output_dir, sub), exist_ok=True)
    s = setup_sampling(args, dev)

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    chamfers, emds, f1s, accs, top3s, lines = [], [], [], [], [], []
    for bi, batch in enumerate(s.loader):
        pred, last = sample_batch(s, batch, gen, args.use_ddim, args.cond_chunk)
        target = torch.from_numpy(batch.target_verts).to(dev)
        nvalid = len(set(batch.seq_names))  # the padded tail repeats the last seq
        for i, seq in enumerate(batch.seq_names[:nvalid]):
            p, tgt = pred[i:i + 1], target[i:i + 1]
            cfd = float(chamfer_distance(p, tgt))
            chamfers.append(cfd)
            emds.append(emd(p, tgt))
            f1s.append(float(fscore(p[0], tgt[0], 0.1)[0]))
            tcat = torch.from_numpy(batch.target_cat[i:i + 1]).to(dev).argmax(dim=1)
            probs = last.cat[i:i + 1, 0, :]
            (top1,) = topk_accuracy(probs, tcat, (1,))
            (top3,) = topk_accuracy(probs, tcat, (3,))
            accs.append(float(top1) / 100.0)
            top3s.append(float(top3) / 100.0)
            lines.append(f"Chamfer distance for seq {seq}: {cfd:.4f}")
            np.save(os.path.join(args.output_dir, "predictions", seq + ".npy"),
                    pred[i].cpu().numpy().astype(np.float32))
            np.save(os.path.join(args.output_dir, "guiding_points", seq + ".npy"),
                    last.guiding[i].cpu().numpy().astype(np.float32))
        print(f"batch {bi}: cfd={np.mean(chamfers):.4f}")

    final = {"cfd": float(np.mean(chamfers)), "emd": float(np.mean(emds)),
             "f1": float(np.mean(f1s)), "acc": float(np.mean(accs)),
             "top3": float(np.mean(top3s))}
    with open(os.path.join(args.output_dir, "results.txt"), "w") as f:
        for line in lines:
            f.write(line + "\n")
        f.write(f"Final Chamfer distance: {final['cfd']:.4f}\n")
        f.write(f"Final EMD: {final['emd']:.4f}\n")
        f.write(f"Final F1 score: {final['f1']:.4f}\n")
        f.write(f"Category accuracy: {final['acc']:.4f}\n")
        f.write(f"Top 3 accuracy: {final['top3']:.4f}\n")
    print(f"CFD {final['cfd']:.4f} | EMD {final['emd']:.4f} | F1 "
          f"{final['f1']:.4f} | acc {final['acc']:.4f} | top3 {final['top3']:.4f}")
    return final


if __name__ == "__main__":
    main()
