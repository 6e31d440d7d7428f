"""Readings that the limits of ``correct`` are set from, on the chip.

    python3 perfbench/calibrate.py --workload NAME --seeds N [N ...]
        [--seconds S] [--control] [--fault half_batch]

Runs the cell once for each seed in one process (set-up paid once for the
kernel library), each run with a short window at the cell's own load, and
prints a JSON line a seed: the numbers compared against the reference, the
reference's seconds, and with ``--control`` the control's readings (the
reference in the nearest precision below the configuration's, compared with
the reference).  ``--fault half_batch`` plants a fault in a train cell's
step: the loss takes half of each batch, the mean over the rest.  The
benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from perfbench import harness  # noqa: E402


def half_batch(family) -> None:
    """Plant a fault in the family's timed path: half of each batch left out.
    A train step takes the first half of each batch, the mean over the rest;
    a sampling request samples the first half of its scenes and hands their
    answers to the second half as well."""
    build, sample = family.port_trainer, family.port_sample

    def port_trainer(cfg, sd, traffic, device):
        state, step = build(cfg, sd, traffic, device)

        def half(state, *batch, t, noise, dropout_mask):
            h = batch[0].shape[0] // 2
            clouds = h * batch[1].shape[1]
            return step(state, *(b[:h] for b in batch), t=t[:h], noise=noise[:h],
                        dropout_mask=dropout_mask[:clouds])

        return state, half

    def port_sample(model, schedule, fused_step, inputs, generator):
        h = inputs["objs"].shape[0] // 2
        out, last = sample(model, schedule, fused_step,
                           {k: v[:h] for k, v in inputs.items()}, generator)
        twice = lambda t: torch.cat([t, t])  # noqa: E731
        return twice(out), type(last)(x0=twice(last.x0), cat=twice(last.cat),
                                      guiding=twice(last.guiding))

    family.port_trainer, family.port_sample = port_trainer, port_sample


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", choices=["half_batch"])
    ap.add_argument("--leaves", action="store_true",
                    help="a train cell's worst leaves: (grad gap, update gap, name, "
                         "program grad, reference grad, program change, reference change)")
    args = ap.parse_args(argv)
    harness.prepare_environment()
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    spec = harness.Spec()
    if args.fault == "half_batch":
        cfg = spec.config(spec.workload(args.workload)["config"])
        half_batch(__import__(f"perfbench.families.{cfg['family']}", fromlist=["x"]))
    dev = torch.device("cuda", 0)
    for seed in args.seeds:
        t0 = time.perf_counter()
        result, run = harness.run_cell(spec, args.workload, seed, args.seconds, False, dev, t0)
        line = {"workload": args.workload, "seed": seed, "fault": args.fault,
                "checks": {k: v for k, (v, _) in run.checks.items()},
                "attempted": len(run.units), "reference_s": run.reference_s,
                "card": torch.cuda.get_device_name(dev)}
        if args.leaves and hasattr(run, "leaves"):
            names, grads, changes, r_grads, r_changes = run.leaves
            gmed, cmed = float(r_grads.median()), float(r_changes.median())
            rows = [(float((g - rg).abs() / max(float(rg), gmed)),
                     float((c - rc).abs() / max(float(rc), cmed)), n, float(g), float(rg),
                     float(c), float(rc)) for n, g, c, rg, rc
                    in zip(names, grads, changes, r_grads, r_changes)]
            line["worst_grad"] = sorted(rows, reverse=True)[:4]
            line["worst_update"] = sorted(rows, key=lambda r: -r[1])[:6]
            line["medians"] = (gmed, cmed)
        if args.control:
            t1 = time.perf_counter()
            line["control"] = run.control()
            line["control_s"] = time.perf_counter() - t1
        if hasattr(run, "losses"):
            line["losses"] = run.losses
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
