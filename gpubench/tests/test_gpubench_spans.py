"""The program's spans on the trace (``gpubench/spans.py``) on the CPU: the
reading on hand-built event lists, the harness's own reading left as it was,
and a rehearsal that prints every number the spans support."""

import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
from torch.autograd import DeviceType

from gpubench import harness, spans, trace

ROOT = harness.ROOT
PROGRAM = ("serve", "serve.prefill", "serve.decode", "serve.sample")


class Event:
    """A kineto event as ``TraceData.from_profiler`` reads it; times in µs."""

    def __init__(self, name, start, dur, device=False, corr=0, thread=1):
        self._name, self._start, self._dur = name, int(start * 1000), int(dur * 1000)
        self._device, self._corr, self.thread = device, corr, thread

    def name(self):
        return self._name

    def device_type(self):
        return DeviceType.CUDA if self._device else DeviceType.CPU

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur

    def correlation_id(self):
        return self._corr


class Prof:
    """What the readers take of a profiler: its kineto results' events."""

    def __init__(self, events):
        events = list(events)
        self.profiler = type("P", (), {})()
        self.profiler.kineto_results = type("R", (), {"events": lambda _: events})()


def launch(name, at, corr, thread=1):
    """A runtime call on the host that launches what carries ``corr``."""
    return Event(name, at, 2, corr=corr, thread=thread)


def kernel(name, start, dur, corr):
    return Event(name, start, dur, device=True, corr=corr)


def window(lo=0, hi=1000):
    return [Event(trace.WINDOW, lo, hi - lo),
            Event(trace.WINDOW, lo, hi - lo, device=True)]


def hand_built():
    """A serving call: a prefill, a decode step whose kernels autograd-like
    launches come from another thread, a sample that copies to the host, a
    copy launched outside every program span, and one kernel whose launch
    was not recorded.  Each program span also has a device-side copy."""
    ev = window(0, 1000) + [
        Event("gpubench.serve", 5, 990),
        Event("serve", 10, 980),
        Event("serve.prefill", 20, 200), launch("cudaLaunchKernel", 30, 1),
        launch("cudaLaunchKernel", 40, 2),
        Event("serve.decode", 300, 200), launch("cudaGraphLaunch", 320, 3, thread=7),
        Event("serve.sample", 550, 100), Event("aten::copy_", 555, 85),
        launch("cudaMemcpyAsync", 570, 4),
        launch("cudaMemcpyAsync", 700, 5),
        kernel("prefill_a", 40, 100, 1), kernel("prefill_b", 140, 60, 2),
        kernel("decode_a", 330, 150, 3), kernel("decode_b", 480, 50, 3),
        kernel("Memcpy DtoH", 590, 20, 4), kernel("Memcpy HtoD", 710, 10, 5),
        kernel("lost", 800, 30, 99), kernel("past_window", 990, 40, 5),
    ]
    ev += [Event(n, s, d, device=True)
           for n, s, d in (("serve", 40, 790), ("serve.prefill", 40, 160),
                           ("serve.decode", 330, 200))]
    return ev


def test_runtime_calls_by_name():
    for name in ("cudaLaunchKernel", "cudaGraphLaunch", "cudaMemcpyAsync", "cuLaunchKernel",
                 "cudaLaunchKernelExC", "cuLaunchKernelEx"):
        assert spans.runtime_call(name), name
    for name in ("aten::cumsum", "serve.decode", "cutlass_gemm", "culprit", "gpubench.serve",
                 "Activity Buffer Request"):
        assert not spans.runtime_call(name), name


def test_device_seconds_by_innermost_launching_span():
    data, at = spans.read_profiler(Prof(hand_built()), PROGRAM)
    # the device-side copies of the program's spans and the harness's are no operations
    assert sorted(data.device_ops.names) == sorted(
        ["prefill_a", "prefill_b", "decode_a", "decode_b", "Memcpy DtoH", "Memcpy HtoD", "lost",
         "past_window"])
    got = spans.device_seconds(data, at, PROGRAM)
    us = {k: round(v * 1e6, 6) for k, v in got.items()}
    # decode_b ran after its span had closed: its launch inside it counts;
    # the graph launched from another thread counts to the span around it;
    # past_window is clipped at the window's end (10 of 40 us)
    assert us == {"serve.prefill": 160, "serve.decode": 200, "serve.sample": 20,
                  "serve": 20, "outside": 0, "unmatched": 30}
    assert math.isclose(sum(got.values()), data.kernel_seconds(""))
    assert spans.span_counts(data, PROGRAM) == {"serve": 1, "serve.prefill": 1,
                                               "serve.decode": 1, "serve.sample": 1}
    # the innermost span takes its launches from the spans around it
    inner = hand_built() + [Event("serve.slot_copy", 25, 10)]
    data, at = spans.read_profiler(Prof(inner), PROGRAM + ("serve.slot_copy",))
    got = spans.device_seconds(data, at, PROGRAM + ("serve.slot_copy",))
    assert round(got["serve.slot_copy"] * 1e6, 6) == 100 and round(got["serve.prefill"] * 1e6) == 60


def _same(a: trace.TraceData, b: trace.TraceData):
    for side in ("device_ops", "host"):
        x, y = getattr(a, side), getattr(b, side)
        assert x.names == y.names
        for arr in ("idx", "start", "end"):
            np.testing.assert_array_equal(getattr(x, arr), getattr(y, arr))
    assert (a.lo, a.hi, a.busy_s, a.window_s) == (b.lo, b.hi, b.busy_s, b.window_s)
    assert a.breakdown() == b.breakdown()
    assert a.kernel_seconds("a") == b.kernel_seconds("a")


def test_a_trace_without_program_spans_reads_as_the_harness_reads_it():
    """No program span: the same arrays, busy time, kernels, breakdown and
    gap names as ``TraceData.from_profiler``; with program spans, the same
    device operations and busy time."""
    plain = [e for e in hand_built() if e.name() not in PROGRAM]
    data, _ = spans.read_profiler(Prof(plain))
    _same(data, trace.TraceData.from_profiler(Prof(plain)))
    assert spans.idle_gaps(data, ()) == data.breakdown()["idle_gaps"]
    with_spans, _ = spans.read_profiler(Prof(hand_built()), PROGRAM)
    no_copies = [e for e in hand_built()
              if not (e.device_type() == DeviceType.CUDA and e.name() in PROGRAM)]
    harness_read = trace.TraceData.from_profiler(Prof(no_copies))
    _same(with_spans, harness_read)
    rng = np.random.default_rng(4)
    for _ in range(20):     # random traces: the two readings agree
        ev = window(0, 100)
        for c in range(int(rng.integers(1, 30))):
            t = float(rng.uniform(-10, 110))
            ev.append(launch("cudaLaunchKernel", t, c))
            start, dur = t + float(rng.uniform(0, 5)), float(rng.uniform(1, 9))
            ev.append(kernel(f"k{c % 4}", start, dur, c))
        rng.shuffle(ev)
        data, _ = spans.read_profiler(Prof(ev))
        _same(data, trace.TraceData.from_profiler(Prof(ev)))


def test_idle_gaps_name_the_program_span_around_them():
    data, _ = spans.read_profiler(Prof(hand_built()), PROGRAM)
    gaps = spans.idle_gaps(data, PROGRAM)
    by_us = {round(g * 1e6, 6): name for name, g in gaps}
    # inside serve.sample, during the host's copy
    assert by_us[60] == "gpubench.serve / serve.sample / aten::copy_"
    # the prefill's span ended at 220 us: the middle, 265, lies in serve alone
    assert by_us[130] == "gpubench.serve / serve / no op"
    assert by_us[40] == "gpubench.serve / serve.prefill / no op"
    # the harness's breakdown: the same gaps, without the program's layer
    harness_gaps = data.breakdown()["idle_gaps"]
    assert [g for _, g in harness_gaps] == [g for _, g in gaps]
    assert dict((round(g * 1e6, 6), n) for n, g in harness_gaps)[60] == \
        "gpubench.serve / aten::copy_"


def test_tracer_enables_the_program_only_while_it_records():
    import time

    import torch

    from repro_torch import obs

    obs.disable()
    tracer = spans.ProgramTracer(True, cuda=False, seconds=3.0)
    on, start = [], time.perf_counter()
    while time.perf_counter() - start < 3.0:
        phase = tracer.boundary(time.perf_counter() - start)
        assert obs.enabled() == (phase == "on")
        with tracer.span("gpubench.serve"), obs.span("serve"):
            if obs.enabled():
                obs.metrics().counter("serve.decode_rows").inc(2)
            torch.ones(32, 32) @ torch.ones(32, 32)
            time.sleep(0.03)
        on.append(phase == "on")
    tracer.end()
    assert not obs.enabled() and obs.get_telemetry().events == []
    assert tracer.counters == {"serve.decode_rows": 2 * sum(on)} and tracer.program == ["serve"]
    assert spans.span_counts(tracer.data, ["serve"]) == {"serve": sum(on)}
    assert len(tracer.launch) == len(tracer.data.device_ops.idx) == 0


@pytest.mark.parametrize("cell", ["stablelm_3b.chat_single", "stablelm_3b.train_4k"])
def test_rehearsal_prints_every_span_reading(tmp_path, cell):
    """``spans.py --rehearse``: ``run.py``'s traced line, then the spans'
    line with every number; the device's as not measured (None) on the CPU,
    the slot-use share from the Server's counters."""
    env = dict(os.environ)
    for k in ("HOME", "XDG_CACHE_HOME", "TMPDIR"):
        env[k] = str(tmp_path / k.lower())
        os.makedirs(env[k], exist_ok=True)
    env.pop("PYTHONPATH", None)
    # one thread: beside other workers, the recorded stretch must still start
    # inside the window (its calls take about 0.3 s alone)
    env["OMP_NUM_THREADS"] = "1"
    out = subprocess.run([sys.executable, str(ROOT / "gpubench" / "spans.py"), "--workload", cell,
                          "--seed", "3000000011", "--seconds", "12", "--rehearse"],
                         capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    result = json.loads(lines[-2])
    assert result["correct"] is True and set(result["metrics"]) == {
        m["name"] for m in harness.load_json(ROOT / "BENCHMARK.json")["per_layer"]
        if cell in m["workloads"]}
    tag, body = lines[-1].split(" ", 1)
    got = json.loads(body)
    assert tag == "gpubench.spans" and got["busy_s"] is None and got["device_s"] == {}
    m = got["metrics"]
    if cell.endswith("train_4k"):
        assert set(m) == {"trainer.forward_ms_per_step", "trainer.backward_ms_per_step",
                          "trainer.optimizer_ms_per_step", "phases_cover_busy"}
        assert all(v is None for v in m.values())
        steps = got["spans"]["gpubench.step"]
        assert steps > 0 and all(got["spans"][s] == steps for s in spans.TRAIN_PHASES)
    else:
        assert set(m) == {"server.prefill_us_per_token", "server.decode_ms_per_step",
                          "server.slot_copy_share", "server.slot_use", "phases_cover_busy"}
        assert all(v is None for k, v in m.items() if k != "server.slot_use")
        # one request a call on the rehearsal's slots: one busy row a step
        c = got["counters"]
        slots = harness.load_json(ROOT / "gpubench" / "workloads" / f"{cell}.json")
        slots = slots["rehearsal"]["serve"]["batch_slots"]
        assert m["server.slot_use"] == 1 / slots == c["serve.busy_rows"] / c["serve.decode_rows"]
        assert got["spans"]["serve.decode"] * slots == c["serve.decode_rows"]
