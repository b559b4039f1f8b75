"""A bounded slice of a run under torch.profiler (CUDA activity only),
read into device intervals, kernels by name, launch calls and idle gaps.

The slice opens and closes on a synchronised stream with a spin-kernel
marker each time, so it holds exactly the device work enqueued inside it,
and the markers tie the host's clock to the trace's. A trace that holds no
device event gives no slice: its readers then report nothing.
"""

from __future__ import annotations

import json
import os
import tempfile
import time

MARKER = "spin_kernel"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Slice:
    def __init__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.host0 = time.perf_counter()
        torch.cuda._sleep(1000)
        self.host1 = None

    def close(self):
        import torch

        torch.cuda.synchronize()
        self.host1 = time.perf_counter()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.unlink(path)
        self.prof = None
        return read_events(events, self.host0, self.host1)


def read_events(events, host0: float, host1: float):
    """The slice's device record, or None where the trace lacks its
    markers: {window_s, busy_s, kernels [(name, start_s, dur_s, category)],
    intervals [(start_s, end_s)] merged, launches [start_s] (the host's
    kernel-launch calls), host_of(ts_s) -> host clock, trace_of(host) ->
    trace clock}."""
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    marks = sorted(float(e["ts"]) for e in dev if MARKER in e.get("name", ""))
    if len(marks) < 2:
        return None
    m0, m1 = marks[0] / 1e6, marks[-1] / 1e6
    kernels = []
    for e in dev:
        ts, dur = float(e["ts"]) / 1e6, float(e.get("dur", 0.0)) / 1e6
        if MARKER in e.get("name", "") or ts < m0 or ts > m1:
            continue
        kernels.append((e.get("name", "?"), ts, dur, e.get("cat")))
    kernels.sort(key=lambda k: k[1])
    launches = sorted(float(e["ts"]) / 1e6 for e in events if e.get("ph") == "X" and e.get("cat") == "cuda_runtime"
                      and "Launch" in e.get("name", "") and m0 <= float(e["ts"]) / 1e6 <= m1)
    merged = []
    for _, ts, dur, _ in kernels:
        if merged and ts <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], ts + dur)
        else:
            merged.append([ts, ts + dur])
    busy = sum(b - a for a, b in merged)
    scale = (host1 - host0) / max(m1 - m0, 1e-12)
    return dict(window_s=m1 - m0, busy_s=busy, kernels=kernels, intervals=merged, m0=m0, m1=m1, launches=launches,
                host_of=lambda ts: host0 + (ts - m0) * scale, trace_of=lambda t: m0 + (t - host0) / scale)


def breakdown(rec, spans, main_thread: int) -> dict:
    """The ten device operations that took most time and the ten longest
    idle gaps, each gap named by the innermost harness span open on the
    main thread at its middle."""
    by_name: dict[str, float] = {}
    for name, _, dur, _ in rec["kernels"]:
        by_name[name[:160]] = by_name.get(name[:160], 0.0) + dur
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = []
    edges = [rec["m0"]] + [x for ab in rec["intervals"] for x in ab] + [rec["m1"]]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            gaps.append((a, b))
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for a, b in gaps[:10]:
        mid = rec["host_of"]((a + b) / 2)
        label, width = "harness loop", float("inf")
        for n, tid, s0, s1 in spans.items:
            if tid == main_thread and s0 <= mid < s1 and s1 - s0 < width:
                label, width = n, s1 - s0
        named.append([label, b - a])
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": named}
