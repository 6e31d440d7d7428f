"""Where the time of the CAD fitting's pose search goes, on a CUDA device.

    python -m lsdm_tpu_torch.profile_fitting [--contact 1024] [--points 256 576 2048]
        [--sdf_dim 256] [--opt_steps 200] [--repeats 3]

For each object size it scores the 36 x 11 x 11 pose grid
(``fitting/place_obj.py:grid_search``) and refines the best pose with
``--opt_steps`` Adam steps (``refine_pose``) on seeded inputs: a box's
surface of ``--points`` points beside a cluster of ``--contact`` contact
points, against a seeded ``--sdf_dim``^3 grid at the fitting's
normalisation.  It prints the wall time of each call (host clock around a
synchronised call, every one of ``--repeats`` runs after one warm-up),
then traces one grid search and one refinement of the largest object
with ``torch.profiler``: the device time of each kernel, the launches and
the busy share (summed kernel time over the traced wall).  The last line
is one JSON object with all of it.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from lsdm_tpu_torch.fitting.place_obj import grid_search, refine_pose
from lsdm_tpu_torch.profile_sampling import _kernel_times


def inputs(contact: int, points: int, sdf_dim: int, seed: int, dev):
    """(object points, contact points, sdf, centroid, extents) on ``dev``:
    a 1.2 x 0.7 x 0.74 box's surface, a cluster on its top, a smooth
    seeded SDF over a 3 m cube."""
    rs = np.random.RandomState(seed)
    face = rs.randint(0, 3, points)
    pts = (rs.rand(points, 3) - 0.5) * [1.2, 0.7, 0.74]
    pts[np.arange(points), face] = (np.sign(rs.rand(points) - 0.5)
                                    * np.array([0.6, 0.35, 0.37])[face])
    con = (rs.rand(contact, 3) - 0.5) * [1.0, 0.6, 0.02] + [0.9, 0.1, 0.37]
    g = np.linspace(-1.5, 1.5, sdf_dim, dtype=np.float32)
    sdf = (np.sqrt(g[:, None, None] ** 2 + g[None, :, None] ** 2
                   + g[None, None, :] ** 2) - 0.5).astype(np.float32)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    return (t(pts), t(con), t(sdf), t([0.0, 0.0, 0.0]), t([3.0, 3.0, 3.0]))


def profile(contact: int, sizes, sdf_dim: int, opt_steps: int, repeats: int,
            seed: int) -> dict:
    dev = torch.device("cuda", 0)
    result = {"card": torch.cuda.get_device_name(0), "contact": contact,
              "sdf_dim": sdf_dim, "opt_steps": opt_steps, "sizes": {}}

    def timed(fn):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(dev)
        return out, (time.perf_counter() - t0) * 1e3

    calls = {}
    for n in sizes:
        obj, con, sdf, cen, ext = inputs(contact, n, sdf_dim, seed, dev)
        grid = lambda: grid_search(obj, torch.zeros(2, device=dev), con, sdf,  # noqa: E731
                                   cen, ext)
        g, _ = timed(grid)  # warm-up
        start = torch.stack([g.transl_x, g.transl_y])
        rot = float(g.rot_deg)
        refine = lambda: refine_pose(obj, start, rot, con, sdf, cen, ext,  # noqa: E731
                                     opt_steps=opt_steps)
        timed(refine)
        grid_ms = [timed(grid)[1] for _ in range(repeats)]
        refine_ms = [timed(refine)[1] for _ in range(repeats)]
        result["sizes"][n] = {"grid_ms": grid_ms, "refine_ms": refine_ms,
                              "refine_ms_per_step": min(refine_ms) / opt_steps}
        print(f"{n} object points, {contact} contact points: grid search ms "
              f"{[round(x, 3) for x in grid_ms]}, refinement ms "
              f"{[round(x, 3) for x in refine_ms]} "
              f"({min(refine_ms) / opt_steps:.3f} ms a step)")
        calls = {"grid": grid, "refine": refine}

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    result["trace"] = {}
    for name, fn in calls.items():
        with torch.profiler.profile(activities=acts) as prof:
            _, wall = timed(fn)
        kernels = sorted(_kernel_times(prof).items(), key=lambda kv: -kv[1][0])
        busy = sum(ms for ms, _ in dict(kernels).values())
        launches = sum(c for _, c in dict(kernels).values())
        print(f"traced {name} ({sizes[-1]} object points): wall {wall:.3f} ms, "
              f"summed kernel time {busy:.3f} ms, busy share {busy / wall:.3f}, "
              f"{launches} launches")
        for kname, (ms, c) in kernels[:8]:
            print(f"  {ms:10.3f} ms {100 * ms / max(busy, 1e-9):5.1f}%  {c:6d} calls  "
                  f"{kname[:90]}")
        result["trace"][name] = {"wall_ms": wall, "kernel_ms": busy,
                                 "busy_share": busy / wall, "launches": launches,
                                 "kernels": {k: {"ms": ms, "calls": c}
                                             for k, (ms, c) in kernels}}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--contact", type=int, default=1024)
    ap.add_argument("--points", type=int, nargs="+", default=[256, 576, 2048])
    ap.add_argument("--sdf_dim", type=int, default=256)
    ap.add_argument("--opt_steps", type=int, default=200)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_fitting: needs a CUDA device")
    print(json.dumps(profile(args.contact, args.points, args.sdf_dim,
                             args.opt_steps, args.repeats, args.seed)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
