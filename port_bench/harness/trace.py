"""Reduction of a ``torch.profiler`` trace to the benchmark's device numbers.

:func:`summarize` is a frozen copy of ``trace_summary`` in ``chip_smoke.py``
at commit 6cc9e90: the window runs from the first window span to the end of
the last window span or device event; the device is busy where a kernel, a
copy or a fill runs (the union of their intervals, all streams); the
device time of a span class sums the device events whose launch (matched
by the runtime's correlation id) falls inside one of its spans, and its
host time sums the spans' durations. Two changes: the window and the span
classes have separate prefixes, and a launch is matched to its span by a
binary search where the spans do not overlap (the copy's linear scan
otherwise; both pick the earliest span that holds the launch). Attribution
by time assumes one launching thread. :func:`breakdown` adds the device
operations that took the most time and the idle gaps by the span the host
was in.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def load_events(path: str) -> list[dict]:
    """The complete ("X") events of a Chrome trace file."""
    with open(path) as fh:
        return [e for e in json.load(fh)["traceEvents"] if e.get("ph") == "X"]


def _spans(events, prefix: str) -> list[dict]:
    return sorted((e for e in events if e.get("cat") == "user_annotation"
                   and e["name"].startswith(prefix)), key=lambda e: e["ts"])


def _holder(spans: list[dict]):
    """ts -> the earliest span (in start order) that holds ts, or None."""
    starts = [s["ts"] for s in spans]
    disjoint = all(spans[i]["ts"] >= spans[i - 1]["ts"] + spans[i - 1]["dur"]
                   for i in range(1, len(spans)))

    def find(ts):
        if disjoint:
            i = bisect.bisect_right(starts, ts) - 1
            if i >= 0 and spans[i]["ts"] <= ts <= spans[i]["ts"] + spans[i]["dur"]:
                return spans[i]
            return None
        for sp in spans:
            if sp["ts"] <= ts <= sp["ts"] + sp["dur"]:
                return sp
        return None

    return find


def _union(device, t0: float, t1: float) -> list[tuple[float, float]]:
    """Busy intervals of the device events, clipped to [t0, t1]."""
    out: list[tuple[float, float]] = []
    end = t0
    for e in sorted(device, key=lambda e: e["ts"]):
        s, f = max(e["ts"], end), min(e["ts"] + e["dur"], t1)
        if f > s:
            if out and s <= out[-1][1]:
                out[-1] = (out[-1][0], f)
            else:
                out.append((s, f))
            end = f
    return out


def summarize(events: list[dict], window_prefix: str = "bench:",
              prefix: str = "op:") -> dict:
    """Window (s), device busy (s) and share, and per span class calls,
    host ms and device ms."""
    window = _spans(events, window_prefix)
    spans = _spans(events, prefix)
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") in ("cuda_runtime", "cuda_driver")
                 and "correlation" in e.get("args", {})}
    if not window or not device:
        raise ValueError(f"the trace holds {len(window)} window spans and "
                         f"{len(device)} device events")
    t0 = window[0]["ts"]
    t1 = max(max(e["ts"] + e["dur"] for e in window),
             max(e["ts"] + e["dur"] for e in device))
    device = [e for e in device if e["ts"] + e["dur"] > t0 and e["ts"] < t1]
    busy_intervals = _union(device, t0, t1)
    busy = sum(f - s for s, f in busy_intervals)
    per_class: dict[str, dict] = {}
    for sp in spans:
        row = per_class.setdefault(sp["name"][len(prefix):],
                                   {"calls": 0, "host_ms": 0.0, "device_ms": 0.0})
        row["calls"] += 1
        row["host_ms"] += sp["dur"] / 1e3
    find = _holder(spans)
    for e in device:
        ts = launch_ts.get(e.get("args", {}).get("correlation"))
        sp = find(ts) if ts is not None else None
        if sp is not None:
            per_class[sp["name"][len(prefix):]]["device_ms"] += e["dur"] / 1e3
    return {"window_s": (t1 - t0) / 1e6, "busy_s": busy / 1e6,
            "busy_share": busy / (t1 - t0), "per_class": per_class,
            "t0": t0, "t1": t1, "busy_intervals": busy_intervals,
            "device": device, "spans": spans}


def breakdown(summary: dict, top: int = 10) -> dict:
    """The ``top`` device operations by time, and the longest idle gaps
    summed by the span the host was in at each gap's middle, in seconds."""
    ops: dict[str, float] = defaultdict(float)
    for e in summary["device"]:
        ops[e["name"]] += e["dur"] / 1e6
    gaps: dict[str, float] = defaultdict(float)
    find = _holder(summary["spans"])
    edges = [summary["t0"]]
    for s, f in summary["busy_intervals"]:
        edges += [s, f]
    edges.append(summary["t1"])
    for s, f in zip(edges[::2], edges[1::2]):
        if f > s:
            sp = find((s + f) / 2)
            gaps[sp["name"] if sp is not None else "outside op spans"] += (f - s) / 1e6
    return {"device_ops": sorted(([k, v] for k, v in ops.items()), key=lambda kv: -kv[1])[:top],
            "idle_gaps": sorted(([k, v] for k, v in gaps.items()), key=lambda kv: -kv[1])[:top]}
