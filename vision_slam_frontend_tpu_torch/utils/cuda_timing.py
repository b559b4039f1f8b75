"""Timing of work on the card: device time per launch and the cost of one call.

`device_ms` is what a kernel's table reports. It captures DEVICE_LAUNCHES
back-to-back calls of `fn` in one CUDA graph and replays it behind a spin of
the stream (`torch.cuda._sleep`). The timed window opens after the spin ends,
and the host has enqueued the whole replay by then (checked: the start event
must still be pending when the replay is enqueued, else the spin doubles and
the repeat is taken again), so the host's cost never shows in the window: it
is the device's time alone, per call, median over DEVICE_REPEATS replays.

`call_ms` is the older number: CUDA events around one Python call on an idle
card (median of CALL_RUNS), which includes the call's host work before its
launches. That is what one call costs a launch-bound step.

`profiled_kernel_ms` reads torch.profiler's device durations of the kernels whose
name contains a given symbol, over stream launches: a cross-check of
`device_ms` that counts kernel time alone, without the gaps between kernels.
The profiler's device trace (CUPTI) is not always there: a process may get
none, so the cross-check reports "not measured" (None) rather than failing,
and the CUDA-event times above stay the figures of record.
"""

from __future__ import annotations

import statistics

import torch

WARMUP_CALLS = 3  # stream calls before any timing
DEVICE_LAUNCHES = 50  # launches per graph replay
DEVICE_REPEATS = 5  # replays; the median is reported
CALL_RUNS = 30  # single calls; the median is reported
SLEEP_CYCLES = 1 << 21  # about 1 ms at the H100's clock; doubled while too short
MAX_SLEEP_CYCLES = 1 << 31


def call_ms(fn) -> float:
    """Median time of one call of `fn` between two CUDA events, after warm-up
    (host work before the launch included)."""
    for _ in range(WARMUP_CALLS):
        fn()
    times = []
    for _ in range(CALL_RUNS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn) -> float:
    """Device time of one call of `fn` (ms): the median over DEVICE_REPEATS of
    the elapsed time of DEVICE_LAUNCHES back-to-back calls, replayed from one
    CUDA graph that the host enqueued before the window opened, over
    DEVICE_LAUNCHES.

    `fn` must be capturable: no host sync, its inputs already on the card.
    Only its WARMUP_CALLS warm-up calls launch from the stream (and count in
    ops/cuda_kernels.LAUNCHES); the captured calls launch nothing."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture, as graphs require
        for _ in range(WARMUP_CALLS):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(DEVICE_LAUNCHES):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    cycles = SLEEP_CYCLES
    times = []
    while len(times) < DEVICE_REPEATS:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        graph.replay()
        end.record()
        starved = start.query()  # the spin ended before the replay was enqueued
        end.synchronize()
        if starved:
            cycles *= 2
            if cycles > MAX_SLEEP_CYCLES:
                raise RuntimeError("device_ms: the host did not enqueue one graph replay within a 1 s spin")
            continue
        times.append(start.elapsed_time(end) / DEVICE_LAUNCHES)
    del graph
    return statistics.median(times)


def profiled_kernel_ms(fn, symbol: str) -> tuple[float | None, int, int]:
    """(mean device ms per call, kernels per call, device events in all) of
    the CUDA kernels whose name contains `symbol`, from torch.profiler over
    DEVICE_LAUNCHES stream calls of `fn` after warm-up. The ms is None when
    the profiler recorded no such kernel; the third figure then says whether
    it recorded any device event at all."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(WARMUP_CALLS):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(DEVICE_LAUNCHES):
            fn()
        torch.cuda.synchronize()
    device_events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    n_device = sum(e.count for e in device_events)
    events = [e for e in device_events if symbol in e.key]
    count = sum(e.count for e in events)
    if count == 0:
        return None, 0, n_device
    total_us = sum(e.self_device_time_total for e in events)
    return total_us / 1e3 / DEVICE_LAUNCHES, count // DEVICE_LAUNCHES, n_device
