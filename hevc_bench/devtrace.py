"""The device's side of a traced run, from torch.profiler's trace.

`Profile` traces the window (CPU and CUDA activity), writes the trace as a
Chrome trace under TMPDIR, reads back every kernel, copy and memset that
ran on the card, and deletes the file.  A named marker at the start of the
window ties the trace's clock to time.perf_counter(), on which the
harness's own spans run.  The reductions below are plain functions of
(start, end) intervals in seconds.
"""
import heapq
import json
import os
import tempfile
import time
from collections import namedtuple

DeviceOp = namedtuple("DeviceOp", "name kind t0 t1")

DEVICE_KINDS = {"kernel": "kernel", "gpu_memcpy": "memcpy",
                "gpu_memset": "memset"}
MARK = "hevc_bench.window"


class Profile:
    def __init__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        self._torch = torch
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        self.mark_s = None

    def mark(self):
        """Marks the start of the window; returns time.perf_counter()."""
        with self._torch.profiler.record_function(MARK):
            self.mark_s = time.perf_counter()
        return self.mark_s

    def stop(self):
        """Ends the trace; returns the device ops on perf_counter's clock."""
        self._prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                trace = json.load(f)
        finally:
            os.remove(path)
        return device_ops(trace, self.mark_s)


def device_ops(trace, mark_s):
    """The trace's device ops, their times moved onto perf_counter's clock
    by the marker (left on the trace's own clock, in seconds, when the
    marker is missing)."""
    events = trace.get("traceEvents", trace) if isinstance(trace, dict) \
        else trace
    offset = 0.0
    for e in events:
        if e.get("name") == MARK and e.get("ph") == "X" and mark_s:
            offset = mark_s - float(e["ts"]) * 1e-6
            break
    ops = []
    for e in events:
        kind = DEVICE_KINDS.get(str(e.get("cat", "")).lower())
        if kind is None or e.get("ph") != "X":
            continue
        t0 = float(e["ts"]) * 1e-6 + offset
        ops.append(DeviceOp(e.get("name", "?"), kind, t0,
                            t0 + float(e.get("dur", 0)) * 1e-6))
    return ops


def union(intervals):
    """Sorted, disjoint union of (start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def clip(intervals, lo, hi):
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if min(b, hi) > max(a, lo)]


def busy_seconds(intervals, lo, hi):
    """Seconds of [lo, hi] in which at least one interval runs."""
    return sum(b - a for a, b in clip(union(intervals), lo, hi))


def gaps(intervals, lo, hi):
    """The parts of [lo, hi] that no interval covers."""
    out, t = [], lo
    for a, b in clip(union(intervals), lo, hi):
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if hi > t:
        out.append((t, hi))
    return out


def idle_by_host(idle, spans, top=10):
    """Idle seconds grouped by what the host was doing in their middle:
    the innermost span running then, or "harness" where none runs."""
    order = sorted(spans, key=lambda s: s.t0)
    active, k, by = [], 0, {}
    for a, b in sorted(idle):
        t = (a + b) / 2
        while k < len(order) and order[k].t0 <= t:
            heapq.heappush(active, (order[k].t1, k))
            k += 1
        while active and active[0][0] <= t:
            heapq.heappop(active)
        inner = max((order[i] for _, i in active), key=lambda s: s.depth,
                    default=None)
        name = inner.name if inner is not None else "harness"
        by[name] = by.get(name, 0.0) + (b - a)
    return sorted(([n, v] for n, v in by.items()), key=lambda nv: -nv[1])[:top]


def short_name(name):
    """A device op's name without its return type, namespace qualifiers
    and parameter list ("void (anonymous namespace)::k<int, true>(P<int>)"
    -> "k<int, true>")."""
    name = name.replace("(anonymous namespace)::", "").split("(")[0].strip()
    if name.startswith("void "):
        name = name[5:]
    head, _, args = name.partition("<")
    return head.split("::")[-1] + ("<" + args if args else "")


def kernel_base(name):
    """The function name alone ("k<int, true>" -> "k")."""
    return short_name(name).split("<")[0].strip()


def top_ops(ops, top=10):
    by = {}
    for op in ops:
        key = short_name(op.name)
        by[key] = by.get(key, 0.0) + (op.t1 - op.t0)
    return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:top]
