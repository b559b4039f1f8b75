"""The control (the reference one precision step down, in the program's
place) fails each cell's limits, here at a small size on the CPU. On the
card, at each cell's own size: `python3 slam_bench/control.py --workload
<name> --frames <n> --seeds <a> <b> <c>`."""

from __future__ import annotations

import json
from pathlib import Path

import pytest

from slam_bench import common, control
from slam_bench.tiny import tiny_copy

CELLS = [w["name"] for w in json.loads((Path(__file__).resolve().parent.parent / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return tiny_copy(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("seed", [5, 2**31 + 9])
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_comes_out_not_correct(bench, cell, seed):
    got = control.numbers(f"{cell}_tiny", seed, 30, "cpu", bench)
    limits = common.load_cell(f"{cell}_tiny", bench)["limits"]["limits"]
    assert any(not got[k] <= v for k, v in limits.items() if k in got), got
