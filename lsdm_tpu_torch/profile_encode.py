"""Device time of the fused encode's stage kernels, K7 (sa1-sa4) and K8
(fp4-fp1 with the head), on a CUDA device.

    python -m lsdm_tpu_torch.profile_encode [--clouds 9 72] [--reps 50]
        [--dtype float32 bfloat16]
    python -m lsdm_tpu_torch.profile_encode --sweep [--clouds 9 18 36 72]
        [--dtype float32 bfloat16]
    ... [--csrc DIR]

Builds the PointNet++ backbone of ``sdm_proxd()`` with seeded random
weights, and per cloud count (9 = batch 1, 72 = batch 8) seeded random
clouds of 1024 points, their FPS levels and random features at the
stages' widths, as the sampling path hands them to the kernels.  Per
stage it holds the kernel wrapper to its plain version (max abs error)
and times, queued behind a sleep on the card so that the host's pace does
not count: the wrapper (for K7 with its layer-1 matmul ``Z1 = base @ W1'
+ b1'``) and, for K7, that matmul alone (``z1_ms``); and the host's time
to enqueue a wrapper call (``host_ms``), and the sha256 of its output, by
which two trees' outputs compare bit for bit.  ``--dtype bfloat16`` times the
bf16 modes instead (bf16 features, as the bf16 stages hand them on; the
BF16 gate's readings against the plain bf16 version: max and mean error,
the plain version's own bf16 gap, the share of entries that differ; K7's
``z1_ms`` its bf16 operands, ``ops/sa_fused.py:sa_operands``), each
wrapper handed its stage's bf16 weight copies made once
(``rowmlp.bf16_operands``), as the sampler hands them over, where the tree
has them.  It prints a line a stage and, as its last line, one JSON object
with all of it, the card's name and power limit included.  It uses only
the wrappers' public functions, so the same script times any tree of the
package.

``--sweep`` instead times, per stage and cloud count, the kernel under
every launch plan it can take, each held to the plain version: in float32
each row count and cluster size whose layout fits a block
(``ops/rowmlp.py:layout_sa`` / ``layout_fp``), printing the fastest as the
entries of ``rowmlp.MEASURED``; with ``--dtype bfloat16`` each row count of
the bf16 plans (``layout_sa_bf16`` / ``layout_fp_bf16``), printing the
fastest beside the rule's choice (``plan_sa_bf16`` / ``plan_fp_bf16``).
``--csrc DIR`` builds the kernels from another copy of ``csrc/`` (an
edited copy for an ablation, kept in a git-ignored directory), so that a
variant is timed by this same script.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import time

import torch

DIST_OPS = 10  # a squared distance (6 multiplies, 4 adds) and its compare
# the BF16 gate (chip_smoke.py's): every entry within BF16_RTOL x max(1,
# |plain|), the mean error within BF16_GAP_SHARE of the plain version's gap
BF16_RTOL, BF16_GAP_SHARE = 3e-2, 0.5


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


def stage_cases(backbone, levels, g: torch.Generator, compute_dtype=None):
    """The K7 and K8 calls of one encode at these levels, features random
    of order 1 at each stage's widths: a list of dicts with ``name``,
    ``kind`` ("sa" or "fp"), ``args`` of the wrapper and of its plain
    version, ``layer_flops`` (layers 2..L of an SA stage, every layer of an
    FP stage), ``products`` (the operations of every product: those layers,
    an SA stage's Z1 and center term, an FP stage's interpolation), ``ops``
    and ``nbytes`` (the stage's whole function, for its bound) and
    ``desc``.  With ``compute_dtype`` bf16 the features are bf16, as the
    bf16 stages hand them on, and ``nbytes`` counts bf16 outputs; the
    caller passes ``compute_dtype`` after ``args``."""
    from lsdm_tpu_torch.models.pointnet2 import HEAD_ACTS, fold_mlp

    dev = levels[0].device
    feat = (lambda t: t.to(compute_dtype)) if compute_dtype is not None else (lambda t: t)
    out_bytes = 2 if compute_dtype is not None else 4
    sas = (backbone.sa1, backbone.sa2, backbone.sa3, backbone.sa4)
    cases, feats = [], [levels[0]]
    for i, (st, xyz, new_xyz) in enumerate(zip(sas, levels[:4], levels[1:5])):
        folded = fold_mlp(st)
        base = torch.cat([xyz, feats[-1]], -1).contiguous()
        r, ns = st.radius, min(st.nsample, xyz.shape[1])
        widths = [base.shape[2]] + [w.shape[1] for w, _ in folded]
        B, N, S = xyz.shape[0], xyz.shape[1], new_xyz.shape[1]
        layers = 2 * B * S * ns * sum(a * b for a, b in zip(widths[1:-1], widths[2:]))
        products = (2 * B * N * widths[0] * widths[1]  # Z1 at the N points
                    + 2 * B * S * 3 * widths[1]        # the center term
                    + layers)
        ops = products + DIST_OPS * ball_scan(r, ns, xyz, new_xyz)
        nbytes = _nbytes(xyz, new_xyz, base, *(t for wb in folded for t in wb))
        nbytes += out_bytes * B * S * widths[-1]
        cases.append({"name": f"sa{i + 1}", "kind": "sa",
                      "args": (r, ns, xyz, new_xyz, base, folded),
                      "layer_flops": layers, "products": products, "ops": ops,
                      "nbytes": nbytes,
                      "desc": f"N={N} S={S} K={ns} {tuple(widths[1:])}"})
        feats.append(feat(torch.randn(B, S, widths[-1], generator=g, device=dev)))
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
        p2 = feat(torch.randn(xyz2.shape[0], xyz2.shape[1], d2, generator=g,
                              device=dev))
        B, N, S = xyz1.shape[0], xyz1.shape[1], xyz2.shape[1]
        layers = 2 * B * N * sum(w.numel() for w, _ in folded)
        products = 2 * B * N * min(3, S) * d2 + layers
        ops = (DIST_OPS + 1) * B * N * S + products
        nbytes = _nbytes(xyz1, xyz2, p1, p2, *(t for wb in folded for t in wb))
        nbytes += out_bytes * B * N * folded[-1][0].shape[1]
        cases.append({"name": f"fp{i + 1}", "kind": "fp",
                      "args": (xyz1, xyz2, p1, p2, folded, acts),
                      "layer_flops": layers, "products": products, "ops": ops,
                      "nbytes": nbytes,
                      "desc": f"N={N} S={S} in {folded[0][0].shape[0]} "
                              f"{tuple(w.shape[1] for w, _ in folded)}"})
    return cases


def bf16_readings(got, want, want32) -> dict:
    """The BF16 gate's readings of a bf16 mode's output ``got`` against its
    plain bf16 version's ``want``, ``want32`` the plain version's float32
    result on the same inputs: max and mean |got - want|, the gap (mean
    |want - want32|, the plain version's own bf16 rounding) and the share
    of entries that differ."""
    got, want, want32 = got.float(), want.float(), want32.float()
    diff = (got - want).abs()
    return {"max_abs_err": diff.max().item(), "mean_abs_err": diff.mean().item(),
            "gap": (want - want32).abs().mean().item(),
            "differ": (diff > 0).float().mean().item()}


def bf16_args(rowmlp, case) -> tuple:
    """``case["args"]`` for the bf16 mode: the stage's folded layers with
    their bf16 copies made once (``rowmlp.bf16_operands``), as the sampler
    keeps them, where the tree has them (a parent tree's wrapper makes its
    own at every call)."""
    make = getattr(rowmlp, "bf16_operands", None)
    if make is None:
        return case["args"]
    sa = case["kind"] == "sa"
    at = 5 if sa else 4
    args = list(case["args"])
    args[at] = make(args[at], sa)
    return tuple(args)


def card() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip()


def profile(clouds_list, reps: int, seed: int, dtype=None) -> dict:
    from lsdm_tpu_torch.config import sdm_proxd
    from lsdm_tpu_torch.models.sdm import SceneDiffusionModel
    from lsdm_tpu_torch.ops import fp_fused, rowmlp, sa_fused
    from lsdm_tpu_torch.weights import init_weights

    dev = torch.device("cuda", 0)
    model = init_weights(SceneDiffusionModel(sdm_proxd()), seed).to(dev).eval()
    bb = model.pcd_backbone
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    out = {}
    for clouds in clouds_list:
        rows = []
        for case in stage_cases(bb, encode_levels(bb, clouds, g, dev), g, dtype):
            args = case["args"] if dtype is None else bf16_args(rowmlp, case)
            if case["kind"] == "sa":
                kernel = lambda: sa_fused.sa_stage_fused_kernel(*args, dtype)
                plain = sa_fused.sa_stage_fused_plain
                z1 = lambda: sa_fused.sa_operands(args[4], args[5], dtype)
            else:
                kernel = lambda: fp_fused.fp_stage_fused_kernel(*args, dtype)
                plain = fp_fused.fp_stage_fused_plain
                z1 = None
            got = kernel()
            if dtype is None:
                read = {"max_abs_err": (got - plain(*args)).abs().max().item()}
            else:
                read = bf16_readings(got, plain(*args, dtype), plain(*args))
            ms, host_ms = time_queued_ms(kernel, reps, dev)
            rec = {"stage": case["name"], **read, "ms": ms, "host_ms": host_ms,
                   "sha256": hashlib.sha256(got.float().cpu().numpy().tobytes()
                                            ).hexdigest()[:16],
                   "z1_ms": None if z1 is None else time_queued_ms(z1, reps, dev)[0],
                   "layer_gflop": case["layer_flops"] / 1e9,
                   "tflop_s": case["products"] / ms / 1e9}
            print(f"{clouds} clouds {case['name']} {case['desc']}: wrapper "
                  f"{ms:.4f} ms on the card ({rec['tflop_s']:.2f} TFLOP/s of its "
                  f"products), {host_ms:.4f} ms of host a call, Z1 {rec['z1_ms']} ms, "
                  + ", ".join(f"{k} {v:.3g}" for k, v in read.items()))
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


def sweep_bf16(clouds_list, reps: int, seed: int) -> dict:
    """Per cloud count and stage, the bf16 kernel's device ms (queued; K7
    after its bf16 Z1) under every row count of its plans
    (``rowmlp.layout_sa_bf16`` / ``layout_fp_bf16``) and, where a layer
    reads more than 64 channels, also with weight chunks of 128 k, each
    held to the plain bf16 version by the BF16 gate's readings, beside the
    rule's choice (``plan_sa_bf16`` / ``plan_fp_bf16``)."""
    from lsdm_tpu_torch.config import sdm_proxd
    from lsdm_tpu_torch.models.sdm import SceneDiffusionModel
    from lsdm_tpu_torch.ops import fp_fused, rowmlp, sa_fused
    from lsdm_tpu_torch.weights import init_weights

    bf = torch.bfloat16
    dev = torch.device("cuda", 0)
    model = init_weights(SceneDiffusionModel(sdm_proxd()), seed).to(dev).eval()
    bb = model.pcd_backbone
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    chosen_sa, chosen_fp = rowmlp.plan_sa_bf16, rowmlp.plan_fp_bf16
    out = {}
    try:
        for clouds in clouds_list:
            for case in stage_cases(bb, encode_levels(bb, clouds, g, dev), g, bf):
                args = bf16_args(rowmlp, case)
                sa = case["kind"] == "sa"
                if sa:
                    r, ns, xyz, q, base, folded = args
                    z1, w1x, rest = sa_fused.sa_operands(base, folded, bf)
                    widths = tuple(w.shape[1] for w, _ in folded)
                    kernel = lambda: sa_fused.sa_stage_launch(
                        r, ns, xyz, q, z1, w1x, rest, widths, bf)
                    plain = sa_fused.sa_stage_fused_plain
                    rule = chosen_sa(clouds, xyz.shape[1], q.shape[1], ns, widths)
                    layout = lambda rows, kc: rowmlp.layout_sa_bf16(
                        clouds, xyz.shape[1], q.shape[1], ns, widths, rows, kc)
                    fins = widths[:-1]
                    row_counts = rowmlp.sa_rows_bf16(ns)
                else:
                    xyz1, xyz2, _, _, folded, _ = args
                    widths = (folded[0][0].shape[0], *(w.shape[1] for w, _ in folded))
                    kernel = lambda: fp_fused.fp_stage_fused_kernel(*args, bf)
                    plain = fp_fused.fp_stage_fused_plain
                    rule = chosen_fp(clouds, xyz1.shape[1], xyz2.shape[1], widths)
                    layout = lambda rows, kc: rowmlp.layout_fp_bf16(
                        clouds, xyz1.shape[1], xyz2.shape[1], widths, rows, kc)
                    fins = widths[:-1]
                    row_counts = rowmlp.BF16_FP_ROWS
                want, want32 = plain(*args, bf), plain(*args)
                res = {}
                kcs = [None] + ([128] if max(fins) > 64 else [])
                for rows, kc in ((r, k) for r in row_counts for k in kcs):
                    plan = layout(rows, kc)
                    if plan.smem > rowmlp.SMEM_MAX:
                        continue
                    rowmlp.plan_sa_bf16 = rowmlp.plan_fp_bf16 = lambda *a, p=plan: p
                    read = bf16_readings(kernel(), want, want32)
                    bound = BF16_RTOL * max(1.0, want.float().abs().max().item())
                    if not (read["max_abs_err"] <= bound
                            and read["mean_abs_err"] <= BF16_GAP_SHARE * read["gap"]):
                        raise AssertionError(f"{case['name']} rows {rows}: {read}")
                    res[(rows, plan.kc)] = time_queued_ms(kernel, reps, dev)[0]
                best = min(res, key=res.get)
                ruled = res[(rule.rows, rule.kc)]
                print(f"{clouds} clouds {case['name']} bf16: fastest rows/kc {best[0]}/"
                      f"{best[1]} {res[best]:.4f} ms; rule {rule.rows}/{rule.kc} "
                      f"{ruled:.4f} ms ({ruled / res[best]:.3f}x); " + ", ".join(
                          f"{r}/{k} {ms:.4f}" for (r, k), ms in res.items()))
                out.setdefault(str(clouds), {})[case["name"]] = {
                    "fastest": list(best), "rule": [rule.rows, rule.kc],
                    "ms": {f"{r}/{k}": ms for (r, k), ms in res.items()}}
    finally:
        rowmlp.plan_sa_bf16, rowmlp.plan_fp_bf16 = chosen_sa, chosen_fp
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--clouds", type=int, nargs="+", default=[9, 72])
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sweep", action="store_true",
                    help="time every launch plan of each stage")
    ap.add_argument("--dtype", nargs="+", default=["float32"],
                    choices=["float32", "bfloat16"], help="the modes to time")
    ap.add_argument("--csrc", help="build the kernels from this copy of csrc/")
    args = ap.parse_args(argv)
    if args.csrc:
        from pathlib import Path

        from lsdm_tpu_torch import kernels
        kernels.CSRC = Path(args.csrc).resolve()
    if not torch.cuda.is_available():
        raise SystemExit("profile_encode needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    if args.sweep:
        res = {("sweep" if dt == "float32" else "sweep_bf16"):
               (sweep if dt == "float32" else sweep_bf16)(args.clouds, args.reps,
                                                          args.seed)
               for dt in args.dtype}
    else:
        res = {("stages" if dt == "float32" else "stages_bf16"): profile(
            args.clouds, args.reps, args.seed,
            None if dt == "float32" else torch.bfloat16) for dt in args.dtype}
    print(json.dumps({"card": card(), "device": torch.cuda.get_device_name(0),
                      "seconds": time.perf_counter() - t0, **res}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
