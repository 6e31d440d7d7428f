"""train_launches: launches (``launches.py``) of a traced train step."""

from perfbench.metrics.launches import read  # noqa: F401
