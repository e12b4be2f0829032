"""Reading a ``torch.profiler`` Chrome trace: the device's busy time, the
device operations that took most time, and the longest idle gaps labelled
by what the host was doing."""
from __future__ import annotations

import json

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


def _union(intervals):
    """Merged ``[(start, end)]`` of ``intervals``, sorted."""
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _label(t, marks):
    """The name of the innermost (latest-starting) span of ``marks`` that
    holds time ``t``, else ``host``."""
    held = [(a, name) for name, a, b in marks if a <= t <= b]
    return max(held)[1] if held else "host"


def device_summary(path, labels=(), spans=None):
    """Summary of the trace in ``path``, times in seconds.

    ``busy_s``: the union of the device events' intervals; ``device_ops``:
    ``[name, seconds]`` of the operations with the most time (summed over
    calls); ``idle_gaps``: ``[label, seconds]`` of the longest gaps between
    device events, labelled by the host span that holds the gap's middle:
    the user annotations named in ``labels``, or ``spans`` given as
    ``(name, start_us, end_us)`` in the trace's clock (``t0_us`` of the
    result is the trace's first host event, to place them).
    """
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    dev = [e for e in events
           if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES]
    host = [e for e in events if e.get("ph") == "X" and e.get("cat") not in
            DEVICE_CATEGORIES and "ts" in e]
    by_name = {}
    for e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] / 1e6
    merged = _union((e["ts"], e["ts"] + e["dur"]) for e in dev)
    busy = sum(b - a for a, b in merged) / 1e6
    marks = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in host
             if e["name"] in labels] + list(spans or ())
    gaps = [(b0, a1) for (_a0, b0), (a1, _b1) in zip(merged, merged[1:])]
    gaps.sort(key=lambda g: g[0] - g[1])
    idle = [[_label(0.5 * (a + b), marks), (b - a) / 1e6]
            for a, b in gaps[:TOP]]
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return dict(busy_s=busy, device_ops=[[n[:200], s] for n, s in ops],
                idle_gaps=idle, t0_us=min((e["ts"] for e in host), default=0.0))
