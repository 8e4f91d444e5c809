"""The control of each cell's comparison: the reference put in the program's
place one precision below the configuration's (float8 for bfloat16) has to
come out not correct.

On the card (``gpu`` marker, skipped elsewhere): ``calibrate.py`` at the
cell's own size on three seeds, each control reading over the cell's limit
and each program reading under it.  On the CPU, at the rehearsal sizes: the
control's readings are above the program's, summed over seeds.
"""

import json
import subprocess
import sys

import pytest

from gpubench import harness

ROOT = harness.ROOT
BENCH = harness.load_json(ROOT / "BENCHMARK.json")
CELLS = [c["name"] for c in BENCH["workloads"]]


def calibrate(cell, seeds, rehearse, seconds):
    args = [sys.executable, str(ROOT / "gpubench" / "calibrate.py"), "--workload", cell,
            "--first-seed", "3500000001", "--seeds", str(seeds), "--controls", str(seeds),
            "--seconds", str(seconds)] + (["--rehearse"] if rehearse else [])
    out = subprocess.run(args, capture_output=True, text=True, timeout=3000, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return [json.loads(line) for line in out.stdout.splitlines() if line.startswith("{")]


def numbers(cell, row):
    """``{name: (program reading, control reading)}`` of one seed."""
    if "program" in row:   # training: the float8 control against the float32 reference
        return {k: (row["program"][k], row["control"][k]) for k in row["program"]}
    return {k: (row[k], row[f"control_{k}"]) for k in ("logit_gap", "far_share")}


def limits(cell):
    wl = harness.load_json(harness.GPUBENCH / "workloads" / f"{cell}.json")
    return {k[:-len("_limit")]: v for k, v in wl["check"].items() if k.endswith("_limit")}


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the cell's own size)")
    lim = limits(cell)
    for row in calibrate(cell, 3, False, 1.0 if "chat" not in cell else 3.0):
        got = numbers(cell, row)
        assert all(got[k][0] <= v for k, v in lim.items()), row
        assert any(got[k][1] > v for k, v in lim.items()), row


@pytest.mark.parametrize("cell", CELLS)
def test_control_reads_above_the_program(cell):
    rows = calibrate(cell, 3, True, 0.3)
    totals = {}
    for row in rows:
        for k, (prog, ctrl) in numbers(cell, row).items():
            p, c = totals.get(k, (0.0, 0.0))
            totals[k] = (p + prog, c + ctrl)
    assert any(c > p for p, c in totals.values()), totals
