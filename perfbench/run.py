"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload NAME --seed N --seconds S --trace 0|1

From the root of a checkout, on a machine with an NVIDIA GPU.  Set-up
(imports, the kernel library from its build cache, seeded weights made on
the device, the warm-up) is timed from the process's start to the first
timed request or step; then the cell's traffic runs for ``--seconds``, the
outputs are checked against the plain reference, and the last line of
standard output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each number compared beside its limit.  Exits 2 without a
GPU, 3 where the run loaded JAX or the JAX package.
"""

from __future__ import annotations

import os
import sys
import time


def _process_age() -> float:
    """Seconds since this process started (Linux), 0 where unknown."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T_START = time.perf_counter() - _process_age()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from perfbench import harness  # noqa: E402


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    harness.prepare_environment()
    import torch

    if not torch.cuda.is_available():
        print("perfbench: no CUDA device", file=sys.stderr)
        return 2
    spec = harness.Spec()
    chips = spec.workload(args.workload)["chips"]
    if torch.cuda.device_count() < chips:
        print(f"perfbench: {args.workload} needs {chips} GPUs, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    # the configurations' products in exact float32 (bf16 ones sum in float32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    result, _ = harness.run_cell(spec, args.workload, args.seed, args.seconds,
                                 bool(args.trace), torch.device("cuda", 0), T_START)
    if result is None:
        return 3
    harness.print_result(result)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
