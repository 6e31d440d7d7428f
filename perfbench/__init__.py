"""The benchmark of ``lsdm_tpu_torch``: one cell a run, driven by the names
in ``BENCHMARK.json`` (``python3 perfbench/run.py --workload NAME --seed N
--seconds S --trace 0|1``)."""
