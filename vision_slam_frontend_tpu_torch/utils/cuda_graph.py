"""One capture-and-replay policy for the port's CUDA graphs.

A `CapturedCall` holds one call site's device work as a CUDA graph: the
Frontend's keyframe step (one per `frontend.step_key`, layer `keyframe`)
and the local-BA solve (one per capacity bucket, layer `local_ba`). The
caller owns the static inputs, writes them before each call and hands over a
function of them alone. The first call runs it eagerly, which loads the
kernels and fills the per-device tables outside any capture. The second
captures it (a `<layer>.capture` span) and replays the graph, and every
later call replays it (a `<layer>.replay` span). The graph runs the same
kernels in the same order, so a replay's results equal the eager call's,
and each replay returns the same static output tensors, rewritten.

ops/cuda_kernels counts a hand-written kernel called during a capture in
`CAPTURED` and launches nothing. Each replay adds the calls its capture
recorded to `REPLAYED`, so `cuda_kernels.runs()` counts the kernels that
every replay ran.
"""

from __future__ import annotations

from typing import Callable

import torch

from vision_slam_frontend_tpu_torch.ops import cuda_kernels
from vision_slam_frontend_tpu_torch.utils.profiling import span


class CapturedCall:
    """One call site's CUDA graph: eager at the first call, captured at the
    second, replayed from then on (the second too). `replays` counts the
    replays; `kernels` holds the hand-written kernel calls the graph
    recorded, by wrapper."""

    def __init__(self, layer: str):
        self.layer = layer
        self.graph = None
        self.result = None  # the graph's static output
        self.kernels: dict[str, int] = {}
        self.replays = 0
        self._warm = False

    def __call__(self, fn: Callable, request):
        """`fn()` on the caller's static inputs; `request` names the unit of
        work in the spans (a keyframe, a window's keyframe)."""
        if not self._warm:
            self._warm = True
            return fn()
        if self.graph is None:
            with span(f"{self.layer}.capture", request):
                before = dict(cuda_kernels.CAPTURED)
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                    self.result = fn()
                self.graph = graph
                self.kernels = {k: n - before[k] for k, n in cuda_kernels.CAPTURED.items() if n > before[k]}
        with span(f"{self.layer}.replay", request):
            self.graph.replay()
            for k, n in self.kernels.items():
                cuda_kernels.REPLAYED[k] += n
        self.replays += 1
        return self.result
