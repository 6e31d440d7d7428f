"""Where the time of ContactFormer goes, on a CUDA device.

    python -m lsdm_tpu_torch.profile_contact [--frames 256] [--modes 0 1 2 3 4]
        [--repeats 5]

At ``train_contactformer``'s widths (d_hid 512, dim_ff 512, 8 heads, 6 + 6
layers, the POSA VAE's h_dim 512 and z 256) on the synthetic body levels
(655, 164, 41; spirals of 9), seeded weights and one seeded window of
``--frames`` frames (the last quarter padding): each decoder mode's
forward (CUDA events over ``--repeats`` calls after a warm-up), then
mode 1's train step (``train/contact.py``, Adam; host clock around each
synchronised step, ``--repeats`` steps after a warm-up) with its peak
memory, then one traced forward and one traced step of mode 1 with
``torch.profiler``: each kernel's device time, the launches and the busy
share (summed kernel time over the traced wall).  TF32 off.  The last line
is one JSON object with all of it.

    python -m lsdm_tpu_torch.profile_contact --grad_check [--frames 32]

instead measures how far float32 gradients lie from float64 ones: for each
of ``--modes``, one loss's gradients from the same seeded weights and
noise in float32 on the CPU, on the card, and on the card with cuDNN's
TF32 setting left on, each leaf against the CPU's float64 by its 2-norm
distance over its 2-norm (no less than 1e-3 of the largest leaf norm),
with the worst leaves.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from lsdm_tpu_torch.profile_sampling import _kernel_times


def contact_inputs(mode: int, frames: int, seed: int = 0):
    """A seeded ContactFormer (decoder ``mode``, ``seg_len`` = ``frames``)
    at ``train_contactformer``'s widths on the synthetic body levels, on
    the CPU, and one window of ``frames`` frames, the last quarter padding:
    (model, (cf, verts, mask), eps)."""
    from lsdm_tpu_torch.data.mesh_assets import load_mesh_assets
    from lsdm_tpu_torch.models.contactformer import ContactFormer
    from lsdm_tpu_torch.weights import init_weights

    assets = load_mesh_assets("", 9)  # no mesh_ds folder: the synthetic levels
    model = init_weights(ContactFormer(assets.spiral_indices, assets.down_mats,
                                       seg_len=frames, decoder_mode=mode), seed)
    g = torch.Generator().manual_seed(seed)
    valid = frames - frames // 4
    nv = assets.nv[0]
    cf = torch.zeros(frames, nv, 8)
    cf[:valid] = torch.nn.functional.one_hot(
        torch.randint(0, 8, (valid, nv), generator=g), 8).float()
    verts = torch.zeros(frames, nv, 3)
    verts[:valid] = torch.randn(valid, nv, 3, generator=g)
    mask = torch.zeros(1, frames)
    mask[0, :valid] = 1.0
    return model, (cf, verts, mask), torch.randn(frames, 256, generator=g)


def _trace(fn, label: str) -> dict:
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = sorted(_kernel_times(prof).items(), key=lambda kv: -kv[1][0])
    busy = sum(ms for _, (ms, _) in kernels)
    launches = sum(c for _, (_, c) in kernels)
    print(f"traced {label}: wall {wall:.3f} ms, summed kernel time {busy:.3f} ms, "
          f"busy share {busy / wall:.3f}, {launches} launches")
    for name, (ms, c) in kernels[:12]:
        print(f"  {ms:10.3f} ms {100 * ms / max(busy, 1e-9):5.1f}%  {c:6d} calls  "
              f"{name[:90]}")
    return {"wall_ms": wall, "kernel_ms": busy, "busy_share": busy / wall,
            "launches": launches,
            "kernels": {k: {"ms": ms, "calls": c} for k, (ms, c) in kernels}}


def profile(frames: int, modes, repeats: int, seed: int) -> dict:
    from lsdm_tpu_torch.train.contact import contact_train_step

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = {"card": torch.cuda.get_device_name(0), "frames": frames,
              "forward_ms": {}}
    for mode in modes:
        model, inputs, eps = contact_inputs(mode, frames, seed)
        model.to(dev).eval()
        args = [t.to(dev) for t in (*inputs, eps)]
        with torch.no_grad():
            model(*args)
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(repeats):
                model(*args)
            end.record()
            torch.cuda.synchronize()
        result["forward_ms"][mode] = start.elapsed_time(end) / repeats
        print(f"mode {mode} forward, {frames} frames: "
              f"{result['forward_ms'][mode]:.3f} ms")
        if mode == 1:
            with torch.no_grad():
                result["trace_forward"] = _trace(lambda: model(*args),
                                                 "mode 1 forward")
        del model, args

    model, inputs, _ = contact_inputs(1, frames, seed)
    model.to(dev).train()
    opt = torch.optim.Adam(model.parameters(), lr=1e-4)
    args = [t.to(dev) for t in inputs]
    g = torch.Generator(device=dev).manual_seed(seed)

    def step():
        contact_train_step(model, opt, *args, 1e-3, generator=g)

    step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ms = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    result["step_ms"] = ms
    result["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    print(f"mode 1 train step, {frames} frames: ms {[round(x, 3) for x in ms]}, "
          f"peak {result['peak_gib']:.2f} GiB")
    result["trace_step"] = _trace(step, "mode 1 train step")
    return result


def grad_check(frames: int, modes, seed: int) -> dict:
    """{mode: {run: (worst error, [(leaf, error), ...] worst three)}} for the
    runs ``cpu32``, ``card32`` and ``card32_cudnn_tf32`` against the CPU's
    float64 gradients (see the module docstring)."""
    from lsdm_tpu_torch.train.contact import contact_loss

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False

    def grads(d, dt, cudnn_tf32=False):
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
        model, inputs, eps = contact_inputs(mode, frames, seed)
        model.to(d, dt).train()
        loss, _ = contact_loss(model, *(t.to(d, dt) for t in inputs), 1e-3,
                               eps=eps.to(d, dt))
        loss.backward()
        torch.backends.cudnn.allow_tf32 = False
        return {n: p.grad.double().cpu() for n, p in model.named_parameters()
                if p.grad is not None}

    result = {}
    for mode in modes:
        want = grads(torch.device("cpu"), torch.float64)
        floor = 1e-3 * max(float(g.norm()) for g in want.values())
        runs = {"cpu32": grads(torch.device("cpu"), torch.float32),
                "card32": grads(dev, torch.float32),
                "card32_cudnn_tf32": grads(dev, torch.float32, True)}
        result[mode] = {}
        for run, got in runs.items():
            errs = sorted(((float((got[n] - g).norm()) / max(float(g.norm()), floor), n)
                           for n, g in want.items()), reverse=True)
            result[mode][run] = (errs[0][0], [(n, e) for e, n in errs[:3]])
            print(f"mode {mode} {run} against float64, {frames} frames: worst "
                  f"{errs[0][0]:.3g}; {[(n, f'{e:.3g}') for e, n in errs[:3]]}")
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=256)
    ap.add_argument("--modes", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--grad_check", action="store_true",
                    help="float32 gradients against float64 instead of times")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_contact: needs a CUDA device")
    if args.grad_check:
        print(json.dumps(grad_check(args.frames, args.modes, args.seed)))
        return 0
    print(json.dumps(profile(args.frames, args.modes, args.repeats, args.seed)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
