"""Device time of the fused encode's stage kernels, K7 (sa1-sa4) and K8
(fp4-fp1 with the head), on a CUDA device.

    python -m lsdm_tpu_torch.profile_encode [--clouds 9 72] [--reps 50]
    python -m lsdm_tpu_torch.profile_encode --sweep [--clouds 9 18 36 72]

Builds the PointNet++ backbone of ``sdm_proxd()`` with seeded random
weights, and per cloud count (9 = batch 1, 72 = batch 8) seeded random
clouds of 1024 points, their FPS levels and random features at the
stages' widths, as the sampling path hands them to the kernels.  Per
stage it holds the kernel wrapper to its plain version (max abs error)
and times, queued behind a sleep on the card so that the host's pace does
not count: the wrapper (for K7 with its layer-1 matmul ``Z1 = base @ W1'
+ b1'``) and, for K7, that matmul alone (``z1_ms``); and the host's time
to enqueue a wrapper call (``host_ms``).  It prints a line a
stage and, as its last line, one JSON object with all of it, the card's
name and power limit included.  It uses only the wrappers' public
functions, so the same script times any tree of the package.

``--sweep`` instead times, per stage and cloud count, the kernel under
every launch plan it can take (``ops/rowmlp.py``: each row count and
cluster size whose layout fits a block), each held to the plain version,
and prints the fastest as the entries of ``rowmlp.MEASURED``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

DIST_OPS = 10  # a squared distance (6 multiplies, 4 adds) and its compare


def time_queued_ms(fn, reps: int, dev=None):
    """(device ms, host ms) per call of fn() after one warm-up: its launches
    enqueued while the card sleeps (~0.1 s), so that they run back to back
    whatever the host's pace, and the host's clock over the enqueueing,
    which the card does not hold up.  ``dev``: the CUDA device (None: the
    current one)."""
    fn()
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e8))
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / reps
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / reps, host


def ball_scan(radius, nsample, xyz, new_xyz) -> int:
    """Distances a ball query needs on this data: per center, the points up
    to its nsample-th in-radius one, or all N where the ball holds fewer."""
    from lsdm_tpu_torch.ops.ballquery import _radius2, square_distance

    inside = square_distance(new_xyz, xyz) <= _radius2(radius)
    full = inside.sum(-1) >= nsample
    kth = (inside.cumsum(-1) >= nsample).int().argmax(-1)
    return int(torch.where(full, kth + 1, xyz.shape[1]).sum())


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def encode_levels(backbone, clouds: int, g: torch.Generator, dev):
    """Seeded clouds (clouds, 1024, 3) and the point sets of the SA stages:
    [l0, l1 = l0 (sa1 keeps every point), l2, l3, l4] by K3 from point 0."""
    from lsdm_tpu_torch.ops import fps
    from lsdm_tpu_torch.ops.pointcloud import index_points

    n = backbone.sa1.npoint
    levels = [torch.randn(clouds, n, 3, generator=g, device=dev)]
    levels.append(levels[0])
    for st in (backbone.sa2, backbone.sa3, backbone.sa4):
        idx = fps.farthest_point_sample_kernel(levels[-1], st.npoint)
        levels.append(index_points(levels[-1], idx).contiguous())
    return levels


def stage_cases(backbone, levels, g: torch.Generator):
    """The K7 and K8 calls of one encode at these levels, features random
    of order 1 at each stage's widths: a list of dicts with ``name``,
    ``kind`` ("sa" or "fp"), ``args`` of the wrapper and of its plain
    version, ``layer_flops`` (layers 2..L of an SA stage, every layer of an
    FP stage), ``ops`` and ``nbytes`` (the stage's whole function, for its
    bound) and ``desc``."""
    from lsdm_tpu_torch.models.pointnet2 import HEAD_ACTS, fold_mlp

    dev = levels[0].device
    sas = (backbone.sa1, backbone.sa2, backbone.sa3, backbone.sa4)
    cases, feats = [], [levels[0]]
    for i, (st, xyz, new_xyz) in enumerate(zip(sas, levels[:4], levels[1:5])):
        folded = fold_mlp(st)
        base = torch.cat([xyz, feats[-1]], -1).contiguous()
        r, ns = st.radius, min(st.nsample, xyz.shape[1])
        widths = [base.shape[2]] + [w.shape[1] for w, _ in folded]
        B, N, S = xyz.shape[0], xyz.shape[1], new_xyz.shape[1]
        layers = 2 * B * S * ns * sum(a * b for a, b in zip(widths[1:-1], widths[2:]))
        ops = (2 * B * N * widths[0] * widths[1]  # Z1 at the N points
               + 2 * B * S * 3 * widths[1]        # the center term
               + layers + DIST_OPS * ball_scan(r, ns, xyz, new_xyz))
        nbytes = _nbytes(xyz, new_xyz, base, *(t for wb in folded for t in wb))
        nbytes += 4 * B * S * widths[-1]
        cases.append({"name": f"sa{i + 1}", "kind": "sa",
                      "args": (r, ns, xyz, new_xyz, base, folded),
                      "layer_flops": layers, "ops": ops, "nbytes": nbytes,
                      "desc": f"N={N} S={S} K={ns} {tuple(widths[1:])}"})
        feats.append(torch.randn(B, S, widths[-1], generator=g, device=dev))
    fps_ = (backbone.fp4, backbone.fp3, backbone.fp2, backbone.fp1)
    for i, fp in zip((3, 2, 1, 0), fps_):
        folded = fold_mlp(fp)
        acts = ["relu"] * len(folded)
        p1 = feats[i] if i > 0 else None  # the SA output at the targets
        if fp is backbone.fp1:
            folded += backbone.head_folded()
            acts += HEAD_ACTS
        xyz1, xyz2 = levels[i], levels[i + 1]
        d2 = folded[0][0].shape[0] - (0 if p1 is None else p1.shape[2])
        p2 = torch.randn(xyz2.shape[0], xyz2.shape[1], d2, generator=g, device=dev)
        B, N, S = xyz1.shape[0], xyz1.shape[1], xyz2.shape[1]
        layers = 2 * B * N * sum(w.numel() for w, _ in folded)
        ops = (DIST_OPS + 1) * B * N * S + 2 * B * N * min(3, S) * d2 + layers
        nbytes = _nbytes(xyz1, xyz2, p1, p2, *(t for wb in folded for t in wb))
        nbytes += 4 * B * N * folded[-1][0].shape[1]
        cases.append({"name": f"fp{i + 1}", "kind": "fp",
                      "args": (xyz1, xyz2, p1, p2, folded, acts),
                      "layer_flops": layers, "ops": ops, "nbytes": nbytes,
                      "desc": f"N={N} S={S} in {folded[0][0].shape[0]} "
                              f"{tuple(w.shape[1] for w, _ in folded)}"})
    return cases


def card() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip()


def profile(clouds_list, reps: int, seed: int) -> dict:
    from lsdm_tpu_torch.config import sdm_proxd
    from lsdm_tpu_torch.models.sdm import SceneDiffusionModel
    from lsdm_tpu_torch.ops import fp_fused, sa_fused
    from lsdm_tpu_torch.weights import init_weights

    dev = torch.device("cuda", 0)
    model = init_weights(SceneDiffusionModel(sdm_proxd()), seed).to(dev).eval()
    bb = model.pcd_backbone
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    out = {}
    for clouds in clouds_list:
        rows = []
        for case in stage_cases(bb, encode_levels(bb, clouds, g, dev), g):
            args = case["args"]
            if case["kind"] == "sa":
                kernel = lambda: sa_fused.sa_stage_fused_kernel(*args)
                plain = sa_fused.sa_stage_fused_plain
                w1, b1 = args[5][0]
                base = args[4]
                z1 = lambda: (torch.matmul(base, w1) + b1, w1[:3].contiguous())
            else:
                kernel = lambda: fp_fused.fp_stage_fused_kernel(*args)
                plain = fp_fused.fp_stage_fused_plain
                z1 = None
            err = (kernel() - plain(*args)).abs().max().item()
            ms, host_ms = time_queued_ms(kernel, reps, dev)
            rec = {"stage": case["name"], "max_abs_err": err, "ms": ms,
                   "host_ms": host_ms,
                   "z1_ms": None if z1 is None else time_queued_ms(z1, reps, dev)[0],
                   "layer_gflop": case["layer_flops"] / 1e9}
            print(f"{clouds} clouds {case['name']} {case['desc']}: wrapper "
                  f"{ms:.4f} ms on the card, {host_ms:.4f} ms of host a call, "
                  f"Z1 {rec['z1_ms']} ms, max error {err:.3g}")
            rows.append(rec)
        out[str(clouds)] = rows
    return out


def sweep(clouds_list, reps: int, seed: int) -> dict:
    """Per cloud count and stage, the kernel's device ms (queued; K7 after
    its layer-1 matmul) under every plan ``rowmlp.layout_sa`` /
    ``layout_fp`` lays out for a row count and a cluster size, and the
    fastest (rows, cluster) under the key ``rowmlp.MEASURED`` reads."""
    from lsdm_tpu_torch.config import sdm_proxd
    from lsdm_tpu_torch.models.sdm import SceneDiffusionModel
    from lsdm_tpu_torch.ops import fp_fused, rowmlp, sa_fused
    from lsdm_tpu_torch.weights import init_weights

    dev = torch.device("cuda", 0)
    model = init_weights(SceneDiffusionModel(sdm_proxd()), seed).to(dev).eval()
    bb = model.pcd_backbone
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    chosen_sa, chosen_fp = rowmlp.plan_sa, rowmlp.plan_fp
    measured, times = {}, {}
    try:
        for clouds in clouds_list:
            for case in stage_cases(bb, encode_levels(bb, clouds, g, dev), g):
                args = case["args"]
                if case["kind"] == "sa":
                    r, ns, xyz, q, base, folded = args
                    w1, b1 = folded[0]
                    z1, w1x = torch.matmul(base, w1) + b1, w1[:3].contiguous()
                    widths = tuple(w.shape[1] for w, _ in folded)
                    kernel = lambda: sa_fused.sa_stage_launch(
                        r, ns, xyz, q, z1, w1x, folded, widths)
                    want = sa_fused.sa_stage_fused_plain(*args)
                    key = ("sa", xyz.shape[1], q.shape[1], ns, widths)
                    layout, rows_list = rowmlp.layout_sa, rowmlp.SA_ROWS
                else:
                    folded = args[4]
                    kernel = lambda: fp_fused.fp_stage_fused_kernel(*args)
                    want = fp_fused.fp_stage_fused_plain(*args)
                    key = ("fp", args[0].shape[1], args[1].shape[1],
                           (folded[0][0].shape[0],
                            *(w.shape[1] for w, _ in folded)))
                    layout, rows_list = rowmlp.layout_fp, rowmlp.FP_ROWS
                res = {}
                for rows in rows_list:
                    for cluster in rowmlp.CLUSTERS:
                        plan = layout(clouds, *key[1:], rows, cluster)
                        if plan.smem > rowmlp.SMEM_MAX:
                            continue
                        rowmlp.plan_sa = rowmlp.plan_fp = lambda *a, p=plan: p
                        err = (kernel() - want).abs().max().item()
                        if not err <= 2e-6:
                            raise AssertionError(
                                f"{case['name']} rows {rows} cluster {cluster}: "
                                f"max error {err}")
                        res[(rows, cluster)] = time_queued_ms(kernel, reps, dev)[0]
                best = min(res, key=res.get)
                print(f"{clouds} clouds {case['name']}: fastest rows {best[0]} "
                      f"cluster {best[1]} {res[best]:.4f} ms; " + ", ".join(
                          f"{rc[0]}/{rc[1]} {ms:.4f}" for rc, ms in res.items()))
                measured.setdefault(repr(key), {})[clouds] = best
                times.setdefault(str(clouds), {})[case["name"]] = {
                    f"{rc[0]}/{rc[1]}": ms for rc, ms in res.items()}
    finally:
        rowmlp.plan_sa, rowmlp.plan_fp = chosen_sa, chosen_fp
    return {"measured": measured, "ms": times}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--clouds", type=int, nargs="+", default=[9, 72])
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sweep", action="store_true",
                    help="time every launch plan of each stage")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_encode needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    run = sweep if args.sweep else profile
    res = run(args.clouds, args.reps, args.seed)
    print(json.dumps({"card": card(), "device": torch.cuda.get_device_name(0),
                      "seconds": time.perf_counter() - t0,
                      ("sweep" if args.sweep else "stages"): res}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
