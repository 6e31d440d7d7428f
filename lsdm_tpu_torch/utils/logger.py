"""Metrics logging: KV accumulation with CSV/JSONL/stdout writers and
wall-clock profiling contexts.

A copy of ``lsdm_tpu/utils/logger.py`` (it imports no JAX, but the port
imports nothing of the JAX package), without the optional TensorBoard
writer: ``torch.utils.tensorboard`` loads TensorFlow where that is
installed, seconds of start-up for every run, and the CSV/JSONL outputs
carry the same data.

Replaces the reference's three parallel logging systems (SURVEY.md §5.5:
TensorBoard SummaryWriter, the OpenAI-baselines KV logger
``diffusion/logger.py``, and the pluggable TrainPlatform
``run/train_platforms.py``) with one small logger that writes:

  * ``progress.csv``  — one row per dump, columns grow as keys appear
  * ``events.jsonl``  — machine-readable stream (step, key, value, time)
  * stdout            — aligned human table
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Dict, Optional


class KVLogger:
    def __init__(self, log_dir: Optional[str] = None, stdout: bool = False):
        self.log_dir = log_dir
        self.stdout = stdout
        self._kv: Dict[str, float] = {}
        self._kv_counts: Dict[str, int] = defaultdict(int)
        self._csv_keys: list = []
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._jsonl = open(os.path.join(log_dir, "events.jsonl"), "a")
            self._csv_path = os.path.join(log_dir, "progress.csv")
        else:
            self._jsonl = None
        self._timings: Dict[str, list] = defaultdict(list)

    # -- immediate logging -------------------------------------------------
    def log(self, key: str, value: float, step: Optional[int] = None):
        if self._jsonl:
            self._jsonl.write(
                json.dumps({"t": time.time(), "step": step, key: value}) + "\n"
            )
            self._jsonl.flush()
        if self.stdout:
            print(f"[{step}] {key} = {value:.6g}")

    # -- KV accumulation (logkv / logkv_mean / dumpkvs style) -------------
    def logkv(self, key: str, value: float):
        self._kv[key] = value
        self._kv_counts[key] = 1

    def logkv_mean(self, key: str, value: float):
        n = self._kv_counts[key]
        self._kv[key] = (self._kv.get(key, 0.0) * n + value) / (n + 1)
        self._kv_counts[key] = n + 1

    def dumpkvs(self, step: Optional[int] = None) -> Dict[str, float]:
        out = dict(self._kv)
        for k, v in out.items():
            self.log(k, v, step)
        if self.log_dir:
            new_keys = [k for k in out if k not in self._csv_keys]
            if new_keys:
                self._csv_keys.extend(sorted(new_keys))
                # rewrite header preserving old rows
                rows = []
                if os.path.exists(self._csv_path):
                    with open(self._csv_path) as f:
                        rows = f.readlines()[1:]
                with open(self._csv_path, "w") as f:
                    f.write(",".join(self._csv_keys) + "\n")
                    f.writelines(rows)
            with open(self._csv_path, "a") as f:
                f.write(
                    ",".join(str(out.get(k, "")) for k in self._csv_keys) + "\n"
                )
        self._kv.clear()
        self._kv_counts.clear()
        return out

    # -- profiling (reference @profile decorators, diffusion/logger.py:294) -
    @contextlib.contextmanager
    def profile(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            self._timings[name].append(time.time() - t0)

    def timing_means(self) -> Dict[str, float]:
        return {k: sum(v) / len(v) for k, v in self._timings.items() if v}

    def close(self):
        if self._jsonl:
            self._jsonl.close()
