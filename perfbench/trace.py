"""From a ``torch.profiler`` trace to what the per-layer metrics read.

The benchmark marks its own boundaries with ``record_function`` ranges:
``perfbench.unit`` around each request or train step, ``perfbench.encode``
around the model's ``encode_conditioning``, ``perfbench.drain`` around the
synchronise that closes the traced window.  Each device operation is
attributed by the host launch that caused it (its CUDA runtime call, matched
by correlation id), never by its name, so a kernel that is renamed, fused
or split keeps its layer.  Device time is always the union of intervals, so
operations that overlap on two streams are counted once.
"""

from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from perfbench.stats import merge, union_length

UNIT, ENCODE, DRAIN = "perfbench.unit", "perfbench.encode", "perfbench.drain"
TOP = 10  # entries of each breakdown list


@dataclasses.dataclass
class Summary:
    units: int  # requests or steps traced
    window_s: float  # the traced window, from the first unit to the drain's end
    busy_s: float  # union of every device operation in the window
    launches: List[int]  # kernels launched in each unit
    device_ms: List[float]  # union of each unit's kernels, ms
    outside_encode_ms: List[float]  # the same, of kernels launched outside encode
    encode_ms: List[float]  # host time of each unit's encode calls, ms
    unattributed: int  # device operations with no launch event found
    device_ops: List[Tuple[str, float]]  # [(name, seconds)], the longest in all
    idle_gaps: List[Tuple[str, float]]  # [(what the host did, seconds)]


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def _is_runtime(name: str) -> bool:
    return name.startswith("cu")


def summarize(prof) -> Summary:
    """Read a finished ``torch.profiler.profile`` (CPU and CUDA activities)."""
    from torch.autograd import DeviceType

    ranges: Dict[str, List[Tuple[int, int]]] = defaultdict(list)
    launch_at: Dict[int, int] = {}
    host: List[Tuple[int, int, str]] = []
    device: List[Tuple[int, int, str, int]] = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start = e.start_ns()
        end = start + e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                device.append((start, end, name, e.correlation_id()))
            continue
        if name.startswith("perfbench."):
            ranges[name].append((start, end))
        elif _is_runtime(name):
            launch_at[e.correlation_id()] = start
        host.append((start, end, name))
    return _summarize(ranges, launch_at, host, device)


def _summarize(ranges, launch_at, host, device) -> Summary:
    units = sorted(ranges[UNIT])
    if not units:
        raise RuntimeError("the trace holds no unit range")
    encodes = sorted(ranges[ENCODE])
    t0 = units[0][0]
    t1 = max([e for _, e in units] + [e for _, e in ranges[DRAIN]])
    unit_starts = [s for s, _ in units]
    enc_starts = [s for s, _ in encodes]

    def find(starts, spans, t) -> Optional[int]:
        i = bisect.bisect_right(starts, t) - 1
        return i if i >= 0 and spans[i][0] <= t <= spans[i][1] else None

    n = len(units)
    launches = [0] * n
    per_unit: List[List[Tuple[int, int]]] = [[] for _ in range(n)]
    outside: List[List[Tuple[int, int]]] = [[] for _ in range(n)]
    in_window, by_name = [], defaultdict(float)
    unattributed = 0
    for start, end, name, corr in device:
        if end < t0 or start > t1:
            continue
        in_window.append((max(start, t0), min(end, t1)))
        by_name[name] += (end - start) / 1e9
        if _is_copy(name):
            continue
        at = launch_at.get(corr)
        if at is None:
            unattributed += 1
            continue
        u = find(unit_starts, units, at)
        if u is None:
            continue
        launches[u] += 1
        per_unit[u].append((start, end))
        if find(enc_starts, encodes, at) is None:
            outside[u].append((start, end))

    encode_ms = [0.0] * n
    for s, e in encodes:
        u = find(unit_starts, units, s)
        if u is not None:
            encode_ms[u] += (e - s) / 1e6

    busy = merge(in_window)
    gaps = [(a_end, b_start) for (_, a_end), (b_start, _) in zip(busy, busy[1:])]
    if busy:
        gaps += [(t0, busy[0][0]), (busy[-1][1], t1)]
    gaps = sorted((g for g in gaps if g[1] > g[0]), key=lambda g: g[0] - g[1])[:TOP]
    return Summary(
        units=n, window_s=(t1 - t0) / 1e9, busy_s=union_length(in_window) / 1e9,
        launches=launches,
        device_ms=[union_length(iv) / 1e6 for iv in per_unit],
        outside_encode_ms=[union_length(iv) / 1e6 for iv in outside],
        encode_ms=encode_ms, unattributed=unattributed,
        device_ops=sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP],
        idle_gaps=[(_host_label(host, encodes, (s + e) // 2), (e - s) / 1e9)
                   for s, e in gaps])


def _host_label(host, encodes, t) -> str:
    """What the host was doing at ``t``: the innermost host event that
    spans it, prefixed by "encode" when an encode range does."""
    best = None
    for s, e, name in host:
        if s <= t <= e and (best is None or e - s < best[1] - best[0]) \
                and not name.startswith("perfbench."):
            best = (s, e, name)
    where = "encode" if any(s <= t <= e for s, e in encodes) else "host"
    return f"{where}: {best[2] if best else 'no host event'}"[:200]
