"""sample_ms_p95: the 95th percentile over every request of the window,
each timed from its start to its sample on the host, in ms."""

from perfbench.stats import percentile


def read(run):
    if run.cell.traffic["task"] != "sample":
        return None
    return percentile([(end - start) * 1e3 for start, end, _ in run.units], 95)
