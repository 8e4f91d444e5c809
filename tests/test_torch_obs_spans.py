"""The port's telemetry on the profiler's trace, and the spans and counters
that the Server and the trainer record, on the CPU.

* disabled, ``obs.span`` is the shared no-op: it opens no profiler range and
  does no other work, and importing ``repro_torch.obs`` loads no torch;
* enabled under a torch profiler, each span is also a host op of its name on
  the profiler's trace (function scope, not a user annotation: the profiler
  makes no device-side copy of it), nested in the ranges around it and as
  long as its ``SpanRecord``, and the Server's and the trainer's spans are
  there as often as they were recorded;
* a small eager Server records one ``serve.prefill`` a request, one
  ``serve.decode`` a step, one ``serve.sample`` for each, one
  ``serve.slot_copy`` a request, and counts its prompt tokens, the rows its
  decode steps computed and the busy ones among them;
* a training step records ``train.forward``, ``train.backward`` and
  ``train.optimizer`` in that order, one forward and one backward a
  microbatch.
"""

import dataclasses
import os
import pathlib
import subprocess
import sys
import time
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch import obs
from repro_torch.configs import reduced_config
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.models import Model
from repro_torch.obs import telemetry
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import Request, ServeConfig, Server
from repro_torch.runtime.trainer import TrainConfig, Trainer

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SERVE_SPANS = ("serve", "serve.prefill", "serve.decode", "serve.sample", "serve.slot_copy")
TRAIN_SPANS = ("train.forward", "train.backward", "train.optimizer")


@pytest.fixture
def telemetry_on():
    """The process-wide telemetry, enabled and empty; off and empty after."""
    obs.reset()
    obs.enable()
    try:
        yield obs.get_telemetry()
    finally:
        obs.disable()
        obs.reset()


def _host_events(prof, names):
    """The profiler's host events named in ``names``: (name, start ns, end ns,
    is a user annotation, activity type)."""
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), e.is_user_annotation(),
             e.activity_type())
            for e in prof.profiler.kineto_results.events() if e.name() in names]


def _on_trace(prof, records, names):
    """Each span of ``names`` is on the trace as often as it was recorded, a
    host op of function scope; the trace's events of ``names``."""
    events = _host_events(prof, names)
    assert Counter(e[0] for e in events) == Counter(r.name for r in records if r.name in names)
    assert all(not user and kind == "cpu_op" for _, _, _, user, kind in events)
    return events


def _server(slots=2, **kw):
    cfg = reduced_config("stablelm_3b")
    params = Model(cfg, device="cpu").init(seed=0).state_dict()
    scfg = ServeConfig(batch_slots=slots, max_len=32, max_new_tokens=4, eos=-1, **kw)
    return Server(cfg, scfg, params, device="cpu")


def _requests(lengths=(5, 9, 3, 7, 6), seed=1):
    rng = np.random.default_rng(seed)
    return [Request(uid=i, prompt=rng.integers(1, 200, n, dtype=np.int32))
            for i, n in enumerate(lengths)]


def test_disabled_span_is_the_shared_noop_and_opens_no_range(monkeypatch):
    obs.disable()
    obs.reset()

    def no_range(name):
        raise AssertionError("a disabled span looked for the profiler")

    monkeypatch.setattr(telemetry, "_profiler_range", no_range)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("outer"):
            span = obs.span("prog.off", attr=1)
            assert span is obs.NULL_SPAN and obs.get_telemetry().span("prog.off") is obs.NULL_SPAN
            with span as inner:
                assert inner is obs.NULL_SPAN and inner.set(x=1) is obs.NULL_SPAN
                torch.ones(8) * 2
    assert _host_events(prof, {"prog.off"}) == []
    assert [e[0] for e in _host_events(prof, {"outer"})] == ["outer"]
    assert obs.get_telemetry().events == []


def test_importing_obs_loads_no_torch():
    """A fresh interpreter: importing the package, and a span enabled there,
    load no torch."""
    code = ("import sys\n"
            "from repro_torch import obs\n"
            "obs.enable()\n"
            "with obs.span('prog.a'):\n"
            "    pass\n"
            "assert len(obs.get_telemetry().events) == 1\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] == 'torch'))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_spans_lie_on_the_profiler_trace(telemetry_on):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("outer"):
            with obs.span("prog.a"):
                torch.ones(64, 64) @ torch.ones(64, 64)
                with obs.span("prog.b"):
                    time.sleep(0.002)
                    torch.ones(8) * 2
                time.sleep(0.001)
    records = telemetry_on.events
    events = _on_trace(prof, records, {"prog.a", "prog.b"})
    (outer,) = [e for e in _host_events(prof, {"outer"})]
    (a,) = [e for e in events if e[0] == "prog.a"]
    (b,) = [e for e in events if e[0] == "prog.b"]
    assert outer[3] and outer[1] <= a[1] <= b[1] < b[2] <= a[2] <= outer[2]
    rec = {r.name: r for r in records}
    assert rec["prog.b"].parent_id == rec["prog.a"].span_id and rec["prog.b"].dur >= 0.002
    for name, start, end, _, _ in (a, b):    # as long as its record: 10 % or 50 us
        dur, want = (end - start) * 1e-9, rec[name].dur
        assert abs(dur - want) <= max(0.1 * want, 50e-6), (name, dur, want)

    # after the profiler: spans record as before, and open no range
    with obs.span("prog.c"):
        pass
    assert telemetry_on.events[-1].name == "prog.c"


def test_server_spans_and_counters(telemetry_on, monkeypatch):
    server = _server()
    steps = []
    step = server._step
    monkeypatch.setattr(server, "_step", lambda tokens: steps.append(1) or step(tokens))
    reqs = _requests()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("gpubench.serve"):
            done = server.serve(reqs)
    records = telemetry_on.events
    counts = Counter(r.name for r in records)
    assert counts == {"serve": 1, "serve.prefill": len(reqs), "serve.decode": len(steps),
                      "serve.sample": len(reqs) + len(steps), "serve.slot_copy": len(reqs)}
    snap = obs.metrics().snapshot()
    # every completion but its first token (the prefill's) was busy one decode row
    busy = sum(len(c.tokens) - 1 for c in done)
    assert snap == {"serve.prefill_tokens": sum(len(r.prompt) for r in reqs),
                    "serve.decode_rows": len(steps) * server.cfg.batch_slots,
                    "serve.busy_rows": busy}
    assert busy < len(steps) * server.cfg.batch_slots     # the last request ran alone
    (call,) = [r for r in records if r.name == "serve"]
    assert all(r.parent_id == call.span_id for r in records if r is not call)
    assert call.attrs == {"requests": len(reqs), "completions": len(reqs)}
    _on_trace(prof, records, set(SERVE_SPANS))
    # the removed metrics stay removed; the serving-health call is unchanged
    assert server.metrics_snapshot()["completions"] == len(reqs)


def test_server_records_nothing_disabled():
    obs.disable()
    obs.reset()
    server = _server()
    server.serve(_requests())
    assert obs.get_telemetry().events == [] and obs.metrics().snapshot() == {}


def _trainer(tmp_path, microbatches):
    cfg = dataclasses.replace(reduced_config("stablelm_3b"), dtype=torch.float32)
    tcfg = TrainConfig(steps=1, checkpoint_every=0, checkpoint_dir=str(tmp_path),
                       attn_impl="xla", microbatches=microbatches)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=4, seed=3)
    return Trainer(cfg, AdamWConfig(lr=1e-3), tcfg, dcfg, device="cpu"), dcfg


@pytest.mark.parametrize("microbatches", [1, 2])
def test_training_step_spans(tmp_path, telemetry_on, microbatches):
    tr, dcfg = _trainer(tmp_path, microbatches)
    params, state = tr.init_state()
    batch = tr._put_batch(SyntheticLM(dcfg).batch(0))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tr.step(params, state, batch)
    names = [r.name for r in sorted(telemetry_on.events, key=lambda r: r.ts)]
    assert names == ["train.forward", "train.backward"] * microbatches + ["train.optimizer"]
    assert all(r.parent_id is None for r in telemetry_on.events)
    _on_trace(prof, telemetry_on.events, set(TRAIN_SPANS))
