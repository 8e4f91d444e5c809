"""The port's ``Server`` with its decode step and its prefills captured as
CUDA graphs, on the CPU.

A CUDA graph exists only on the card, so these tests drive the Server's
graph path through a stand-in for :class:`repro_torch.runtime.serving.StepGraph`
that has a graph's effects: the warm-up runs the step, the capture runs it
for its output alone (the Server's slot state and one-sequence prefill
buffers are put back, as a capture leaves them untouched), and a replay runs
the step again and writes its output where the capture's was.  What runs is
the exact function the Server hands to the capture.  Seven reduced configs
cover the families the Server serves; weights and requests are those of
``tests/test_torch_serving.py``.

* the captured steps read nothing back to the host (a function mode that
  raises on every such call, with ``attn_impl="chunked"``: the kernel's plain
  version reads ``u.any()``, and the card never runs it);
* their tokens and logits equal the eager Server's bit for bit, and follow
  the reference's ``Server.serve`` (float32 logits within
  ``test_torch_serving``'s 1e-4 a step: the dense family's KV cache is
  bfloat16 in either package, and over ten steps a key rounds an ulp apart
  there, 9.3e-5 at most);
* one prefill graph a prompt length, replayed at every later prompt of that
  length, each returning the Server's own one-sequence buffers;
* the host's mirror of the busy slots' positions raises the cache-overflow
  ``ValueError`` before a step would write past the cache, and a prompt
  longer than the cache raises before any capture; a free slot past the
  cache's end serves on, as the reference's does;
* the state buffers live as long as the Server;
* the launch counters equal the launches that ran through capture and replay.
"""

import re
from collections import Counter

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from repro.runtime.serving import Request as JRequest
from repro_torch import obs
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import mamba2_ssd as ssd
from repro_torch.kernels import ops
from repro_torch.runtime import Request, serving

from test_torch_serving import TOL, _compare_runs, _record, _requests, _servers

torch.set_num_threads(1)

ARCHS = ["stablelm_3b", "gemma3_1b", "qwen2_moe_a2_7b", "qwen2_vl_2b", "llama4_scout_17b_a16e",
         "mamba2_370m", "zamba2_2_7b"]

HOST_READS = {
    "item": torch.Tensor.item, "tolist": torch.Tensor.tolist, "__bool__": torch.Tensor.__bool__,
    "__int__": torch.Tensor.__int__, "__float__": torch.Tensor.__float__,
    "__index__": torch.Tensor.__index__, "cpu": torch.Tensor.cpu, "numpy": torch.Tensor.numpy,
}


class NoHostRead(TorchFunctionMode):
    """Raises on every call that would read a tensor's values back to the
    host: on the card, such a call inside a capture fails it."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        for name, banned in HOST_READS.items():
            if func is banned:
                raise AssertionError(f"the captured step reads a value back: Tensor.{name}")
        return func(*args, **(kwargs or {}))


def _leaves(state):
    return [t for leaf in state.values() for t in (leaf if isinstance(leaf, tuple) else (leaf,))]


def _tensors(out):
    """The tensors of a step's output: a tensor, or a tuple of tensors and states."""
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for part in out for t in (_leaves(part) if isinstance(part, dict) else [part])]


def _buffers(server):
    """The Server's slot state and one-sequence prefill buffers, those made yet."""
    return ((_leaves(server._state) if server._state is not None else [])
            + (_tensors(server._prefill_out) if server._prefill_out is not None else []))


class EagerGraph(serving.StepGraph):
    """The stand-in for the CUDA graph (see the module's docstring)."""

    def __init__(self, server, guard, share=None):
        super().__init__(server.device, share)
        self.server, self.guard = server, guard
        self.captures = 0

    def _guarded(self, step):
        if not self.guard:
            return step()
        with NoHostRead():
            return step()

    def warm(self, step):
        return self._guarded(step)

    def _record(self, step):
        leaves = _buffers(self.server)
        saved = [t.clone() for t in leaves]
        self.step, self.out = step, self._guarded(step)
        for t, s in zip(leaves, saved):
            t.copy_(s)
        self.captures += 1
        return self.out

    def _replay(self):
        for out, new in zip(_tensors(self.out), _tensors(self._guarded(self.step))):
            if out is not new:
                out.copy_(new)


def _graphed(server, monkeypatch, guard=False, graph=EagerGraph):
    """``server`` on the graph path, through the stand-in ``graph``."""
    server.cuda_graph = True
    monkeypatch.setattr(serving, "StepGraph",
                        lambda device, share=None: graph(server, guard, share))
    return server


def test_the_guard_sees_every_host_read():
    t = torch.ones(1)
    calls = {"item": t.item, "tolist": t.tolist, "__bool__": lambda: bool(t),
             "__int__": lambda: int(t), "__float__": lambda: float(t),
             "__index__": lambda: range(5)[t.long()], "cpu": t.cpu, "numpy": t.numpy}
    assert sorted(calls) == sorted(HOST_READS)
    for name, call in calls.items():
        with pytest.raises(AssertionError, match=re.escape(f"Tensor.{name}")):
            with NoHostRead():
                call()
    with NoHostRead():
        assert (t + 1).shape == (1,)


@pytest.mark.parametrize("arch", ARCHS)
def test_captured_step_reads_nothing_back(arch, monkeypatch):
    server, _ = _servers(arch=arch, attn_impl="chunked")
    _graphed(server, monkeypatch, guard=True)
    done = server.serve(_requests(Request))
    assert [len(c.tokens) for c in done] == [4] * 5
    graph = server.graph
    assert graph.captures == 1 and graph.replays >= 2


@pytest.mark.parametrize("arch", ARCHS)
def test_graph_matches_eager_and_reference(arch, monkeypatch):
    server, jserver = _servers(arch=arch)
    eager, _ = _servers(arch=arch)
    _graphed(server, monkeypatch)
    calls, ecalls, jcalls = _record(server, False), _record(eager, False), _record(jserver, True)
    done = server.serve(_requests(Request))
    edone = eager.serve(_requests(Request))
    jdone = jserver.serve(_requests(JRequest))
    assert [c.tokens for c in done] == [c.tokens for c in edone]
    assert [k for k, _ in calls] == [k for k, _ in ecalls]
    for (kind, got), (_, want) in zip(calls, ecalls):
        np.testing.assert_array_equal(got, want, err_msg=kind)
    assert server.graph.replays == [k for k, _ in calls].count("decode") - 1
    compared, to_the_end = _compare_runs(calls, jcalls, done, jdone, tol=TOL)
    assert compared >= 5 and to_the_end


def _spied(server, monkeypatch):
    """``server.model.decode_step``'s calls, kept in a list."""
    calls = []
    step = server.model.decode_step

    def spy(*args, **kw):
        calls.append(kw.get("check_room", True))
        return step(*args, **kw)

    monkeypatch.setattr(server.model, "decode_step", spy)
    return calls


@pytest.mark.parametrize("graph", [True, False])
def test_host_mirror_raises_before_the_write(graph, monkeypatch):
    """2 slots of a cache of 8.  A busy slot: a 6-token prompt overruns it at
    its third decode step, which raises before the step, with the message of
    the model's own check, and the state stays as it was.  A free slot:
    prompts of 2 and 5 tokens end together after 3 steps, the third request
    takes slot 0 at position 2 and slot 1, free, stands at 8, past which it
    decodes on with its output unread: the Server serves to the end with the
    reference's tokens and logits (its clamped insert is the reference's)."""
    def servers():
        s, js = _servers(max_len=8)
        return (_graphed(s, monkeypatch) if graph else s), js

    busy, _ = servers()
    calls = _spied(busy, monkeypatch)
    with pytest.raises(ValueError, match=re.escape(
            "KV cache of length 8 cannot take 1 token(s) starting at positions 8..8")):
        busy.serve([Request(uid=0, prompt=np.arange(1, 7, dtype=np.int32))])
    assert busy._state["pos"].tolist() == [8, 8]
    assert len(calls) == (3 if graph else 2)    # warm-up, capture, replay: no fourth call

    free, jfree = servers()
    calls = _spied(free, monkeypatch)
    logits, jlogits = _record(free, False), _record(jfree, True)
    lengths = (2, 5, 2)
    done = free.serve([Request(uid=i, prompt=np.arange(1, n + 1, dtype=np.int32))
                       for i, n in enumerate(lengths)])
    jdone = jfree.serve([JRequest(uid=i, prompt=np.arange(1, n + 1, dtype=np.int32))
                         for i, n in enumerate(lengths)])
    assert [c.tokens for c in done] == [c.tokens for c in jdone]
    assert [len(c.tokens) for c in done] == [4] * 3
    compared, to_the_end = _compare_runs(logits, jlogits, done, jdone, tol=TOL)
    assert compared == 9 and to_the_end      # 3 prefills, 6 steps, the free row's logits too
    assert free._state["pos"].tolist() == [5, 11]
    assert free._positions.tolist() == [5, 11]
    # warm-up, capture and 5 replays; every step skips the model's check: the
    # mirror holds it
    assert calls == [False] * (7 if graph else 6)
    # the model's own check raises on the eager step
    _, state = free.model.prefill({"tokens": torch.ones((2, 1), dtype=torch.int32)}, 8)
    state["pos"] = torch.tensor([2, 8], dtype=torch.int32)
    with pytest.raises(ValueError, match=re.escape("positions 2..8")):
        free.model.decode_step(torch.ones((2, 1), dtype=torch.int32), state)


@pytest.mark.parametrize("graph", [True, False])
@pytest.mark.parametrize("arch", ["stablelm_3b", "zamba2_2_7b"])
def test_serve_calls_reuse_the_state_buffers(arch, graph, monkeypatch):
    """Two ``serve`` calls write into the same state (one capture serves
    both), and the second gives what a fresh Server gives."""
    def server():
        s, _ = _servers(arch=arch)
        return _graphed(s, monkeypatch) if graph else s

    first = server()
    first.serve(_requests(Request))
    ptrs = [t.data_ptr() for t in _leaves(first._state)]
    later = [Request(uid=i, prompt=(np.arange(3 + 2 * i, dtype=np.int32) * 7) % 250 + 1)
             for i in range(3)]
    again = first.serve(later)
    assert [t.data_ptr() for t in _leaves(first._state)] == ptrs
    fresh = server().serve(later)
    assert [c.tokens for c in again] == [c.tokens for c in fresh]
    if graph:
        assert first.graph.captures == 1


#: prompt lengths with repeats: three prefill graphs, each replayed
PREFILL_LENGTHS = (4, 6, 4, 9, 6, 4)


def _prompts(cls, lengths=PREFILL_LENGTHS):
    return [cls(uid=i, prompt=(np.arange(n, dtype=np.int32) * 7 + i) % 250 + 1)
            for i, n in enumerate(lengths)]


@pytest.mark.parametrize("arch", ARCHS)
def test_captured_prefill_reads_nothing_back(arch, monkeypatch):
    """Every prefill graph's warm-up, capture and replays under the guard, in
    one ``serve`` call and the next."""
    server, _ = _servers(arch=arch, attn_impl="chunked")
    _graphed(server, monkeypatch, guard=True)
    for _ in range(2):
        done = server.serve(_prompts(Request))
        assert [len(c.tokens) for c in done] == [4] * len(PREFILL_LENGTHS)
    graphs = server.prefill_graphs
    assert sorted(graphs) == [4, 6, 9]
    assert [graphs[n].captures for n in (4, 6, 9)] == [1, 1, 1]
    assert [graphs[n].replays for n in (4, 6, 9)] == [5, 3, 1]


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_graphs_match_eager_and_reference(arch, monkeypatch):
    """One prefill graph a prompt length, captured at its first prompt and
    replayed at every later one: the five requests of ``test_torch_serving``
    twice (the second call replays every length), then prompts whose lengths
    repeat within the call.  Every prefill's logits and every token equal
    the eager Server's bit for bit; the first two calls follow the
    reference's (the third runs longer than the bfloat16 KV caches of the
    two packages stay within 1e-4 of each other); every prefill graph
    returns the Server's own one-sequence buffers, the same for every
    length."""
    server, jserver = _servers(arch=arch)
    eager, _ = _servers(arch=arch)
    _graphed(server, monkeypatch)
    calls, ecalls, jcalls = _record(server, False), _record(eager, False), _record(jserver, True)
    returned = []
    recorded = server._prefill

    def spy(tokens):
        out = recorded(tokens)
        returned.append((tokens.shape[1], [t.data_ptr() for t in _tensors(out)]))
        return out

    server._prefill = spy
    done = server.serve(_requests(Request)) + server.serve(_requests(Request))
    jdone = jserver.serve(_requests(JRequest)) + jserver.serve(_requests(JRequest))
    compared, to_the_end = _compare_runs(calls, jcalls, done, jdone, tol=TOL)
    assert compared == len(calls) and to_the_end
    done += server.serve(_prompts(Request))
    edone = (eager.serve(_requests(Request)) + eager.serve(_requests(Request))
             + eager.serve(_prompts(Request)))
    assert [c.tokens for c in done] == [c.tokens for c in edone]
    assert [k for k, _ in calls] == [k for k, _ in ecalls]
    for (kind, got), (_, want) in zip(calls, ecalls):
        np.testing.assert_array_equal(got, want, err_msg=kind)
    assert [k for k, _ in calls].count("prefill") == 10 + len(PREFILL_LENGTHS)

    graphs = server.prefill_graphs
    assert sorted(graphs) == [4, 5, 6, 7, 8, 9] and all(g.captures == 1 for g in graphs.values())
    assert [graphs[n].replays for n in (4, 5, 6, 7, 8, 9)] == [4, 1, 3, 1, 1, 0]
    own = [t.data_ptr() for t in _tensors(server._prefill_out)]
    assert all([t.data_ptr() for t in _tensors(g.out)] == own for g in graphs.values())
    first = {}
    for length, ptrs in returned:
        if length in first:     # a replay
            assert ptrs == own, length
        first.setdefault(length, ptrs)
    assert all(ptrs != own for ptrs in first.values())   # a first sight: the eager result


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_into_a_state_equals_a_new_one(arch):
    """``Model.prefill(..., out=state)`` (what a prefill graph runs) resets
    ``state``, fills it in place and returns its tensors: the same hidden
    states and decode state as a prefill whose state is made anew, whatever
    ``state`` held; short prompts (a zero conv state) included."""
    server, _ = _servers(arch=arch)
    model = server.model
    for n in (2, 9):
        batch = {"tokens": torch.from_numpy((np.arange(n, dtype=np.int32) * 5) % 250 + 1)[None]}
        h, state = model.prefill(batch, 32)
        out = {k: tuple(torch.full_like(t, 3) for t in v) if isinstance(v, tuple)
               else torch.full_like(v, 3) for k, v in state.items()}
        h_out, got = model.prefill(batch, 32, check_room=False, out=out)
        assert torch.equal(h_out, h)
        assert [t.data_ptr() for t in _leaves(got)] == [t.data_ptr() for t in _leaves(out)]
        for a, b in zip(_leaves(got), _leaves(state)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("arch,raises", [("stablelm_3b", True), ("zamba2_2_7b", True),
                                         ("mamba2_370m", False)])
def test_prompt_past_max_len_raises_before_any_capture(arch, raises, monkeypatch):
    """A prompt of 11 tokens for a cache of 8 raises on the host before a
    prefill runs or is captured (the families with a KV cache); the ssm
    family's state has no length, and it serves the prompt, as the
    reference's does.  A prompt that fits is captured after the raise."""
    server, _ = _servers(arch=arch, max_len=8)
    _graphed(server, monkeypatch)
    prefills = []
    prefill = server.model.prefill
    monkeypatch.setattr(server.model, "prefill",
                        lambda *args, **kw: prefills.append(len(args[0]["tokens"][0]))
                        or prefill(*args, **kw))
    long = [Request(uid=0, prompt=np.arange(1, 12, dtype=np.int32))]
    if raises:
        with pytest.raises(ValueError, match=re.escape(
                "KV cache of length 8 cannot take 11 token(s) starting at positions 0..0")):
            server.serve(long)
        assert prefills == [] and server.prefill_graphs == {} and server._prefill_out is None
    else:
        assert len(server.serve(long)[0].tokens) == 4
        assert sorted(server.prefill_graphs) == [11]
    assert len(server.serve([Request(uid=1, prompt=np.arange(1, 6, dtype=np.int32))])[0].tokens) \
        == 4
    assert 5 in server.prefill_graphs and server.prefill_graphs[5].captures == 1


def test_failed_prefill_capture_raises(monkeypatch):
    """A prompt length whose capture fails raises, with no eager retry and
    no graph kept for it; the lengths captured before still replay."""
    server, _ = _servers()
    _graphed(server, monkeypatch)
    server.serve(_requests(Request))
    assert sorted(server.prefill_graphs) == [4, 5, 6, 7, 8]

    def refuse(self, step):
        raise RuntimeError("operation not permitted when stream is capturing")

    monkeypatch.setattr(EagerGraph, "_record", refuse)
    with pytest.raises(RuntimeError, match="capturing"):
        server.serve([Request(uid=0, prompt=np.arange(1, 10, dtype=np.int32))])
    assert sorted(server.prefill_graphs) == [4, 5, 6, 7, 8]
    assert len(server.serve(_requests(Request))) == 5
    assert all(g.replays == 1 for g in server.prefill_graphs.values())


class GrowingGraph(EagerGraph):
    """The stand-in whose prefill captures report that they grew their pool,
    at the ``grows``-th prefill captures of the test (1-based)."""

    grows = ()
    prefill_captures = 0

    def _record(self, step):
        out = super()._record(step)
        if isinstance(out, tuple):      # a prefill's (logits, state), not a decode step's logits
            GrowingGraph.prefill_captures += 1
            self.pool_bytes = int(GrowingGraph.prefill_captures in self.grows)
        return out


def test_a_pool_that_grows_is_captured_anew_longest_first(monkeypatch):
    """The third length's capture grows the shared pool: every prefill graph
    is captured again, longest prompt first, the longest owning the new pool
    and the others sharing it; later prompts replay the new captures, and
    every prefill still equals the eager Server's bit for bit."""
    monkeypatch.setattr(GrowingGraph, "grows", (3,))
    monkeypatch.setattr(GrowingGraph, "prefill_captures", 0)
    server, _ = _servers()
    eager, _ = _servers()
    _graphed(server, monkeypatch, graph=GrowingGraph)
    calls, ecalls = _record(server, False), _record(eager, False)
    done = server.serve(_prompts(Request)) + server.serve(_prompts(Request))
    edone = eager.serve(_prompts(Request)) + eager.serve(_prompts(Request))
    assert [c.tokens for c in done] == [c.tokens for c in edone]
    for (kind, got), (_, want) in zip(calls, ecalls):
        np.testing.assert_array_equal(got, want, err_msg=kind)
    graphs = server.prefill_graphs
    assert list(graphs) == [9, 6, 4] and server.prefill_recaptures == 1
    assert [graphs[n].captures for n in (9, 6, 4)] == [2, 2, 2]
    assert graphs[9].share is None and graphs[6].share is graphs[4].share is graphs[9]
    assert [graphs[n].replays for n in (4, 6, 9)] == [5, 3, 1]
    assert GrowingGraph.prefill_captures == 6


def test_captures_are_spans_inside_the_step_that_asked(monkeypatch):
    """With telemetry on, every capture and recapture is one
    ``graph.capture`` span inside the ``serve.prefill`` or ``serve.decode``
    that made it, and every decode step, graph or eager, one
    ``serve.decode``."""
    monkeypatch.setattr(GrowingGraph, "grows", (3,))
    monkeypatch.setattr(GrowingGraph, "prefill_captures", 0)
    server, _ = _servers()
    _graphed(server, monkeypatch, graph=GrowingGraph)
    obs.reset()
    obs.enable()
    try:
        server.serve(_prompts(Request))
    finally:
        obs.disable()
    spans = list(obs.get_telemetry().events)
    obs.reset()
    by_id = {r.span_id: r for r in spans}
    captures = [r for r in spans if r.name == "graph.capture"]
    graphs = [server.graph, *server.prefill_graphs.values()]
    assert len(captures) == sum(g.captures for g in graphs) == 1 + 2 * 3
    assert Counter(by_id[r.parent_id].name for r in captures) == {"serve.prefill": 6,
                                                                   "serve.decode": 1}
    decodes = sum(1 for r in spans if r.name == "serve.decode")
    assert decodes == server.graph.replays + 1     # the eager first step, then a replay each


class CountingEagerGraph(EagerGraph):
    """The stand-in with a graph's launch semantics for the wrappers that
    :func:`_counting` installs: what a capture calls is counted (as the
    wrappers count a Python call) and does not run; a replay runs what was
    captured and calls no counted Python."""

    def __init__(self, server, guard, share, log):
        super().__init__(server, guard, share)
        self.log = log

    def _record(self, step):
        self.log["mode"] = "capture"
        try:
            return super()._record(step)
        finally:
            self.log["mode"] = None

    def _replay(self):
        self.log["mode"] = "replay"
        try:
            super()._replay()
        finally:
            self.log["mode"] = None


def _counting(monkeypatch):
    """``ops.flash_attention`` and ``ops.mamba2_ssd`` counted on the CPU as
    their wrappers count the kernel's launches on the card (float32: the
    ``fma`` path), and what ran kept by wrapper and path."""
    log = {"mode": None, "ran": {}}
    for wrapper, paths in ((fa.flash_attention, fa.PATHS), (ssd.mamba2_ssd, ssd.PATHS)):
        monkeypatch.setattr(wrapper, "launches", 0)
        monkeypatch.setattr(wrapper, "launches_by_path", {p: 0 for p in paths})
        plain = getattr(ops, wrapper.__name__)

        def counted(*args, _plain=plain, _wrapper=wrapper, **kw):
            if log["mode"] != "replay":
                _wrapper.launches += 1
                _wrapper.launches_by_path["fma"] += 1
            if log["mode"] != "capture":
                ran = log["ran"].setdefault(_wrapper.__name__, {})
                ran["fma"] = ran.get("fma", 0) + 1
            return _plain(*args, **kw)

        monkeypatch.setattr(ops, wrapper.__name__, counted)
    return log


@pytest.mark.parametrize("arch", ["stablelm_3b", "mamba2_370m", "zamba2_2_7b"])
def test_prefill_counters_equal_the_launches_that_ran(arch, monkeypatch):
    """Through a Server's prefill graphs and its decode graph, in two
    ``serve`` calls: each kernel's counter equals the launches that ran,
    path by path (the SSD of mamba2 and zamba2 in prefill only)."""
    log = _counting(monkeypatch)
    server, _ = _servers(arch=arch)
    _graphed(server, monkeypatch, graph=lambda server, guard, share: CountingEagerGraph(
        server, guard, share, log))
    for _ in range(2):
        server.serve(_prompts(Request))
        for wrapper in (fa.flash_attention, ssd.mamba2_ssd):
            ran = log["ran"].get(wrapper.__name__, {})
            assert wrapper.launches == sum(ran.values())
            assert {p: n for p, n in wrapper.launches_by_path.items() if n} == ran
    layers = server.model.cfg.n_layers
    prefills = 2 * len(PREFILL_LENGTHS)
    if arch != "stablelm_3b":
        assert ssd.mamba2_ssd.launches == layers * prefills
    if arch != "mamba2_370m":
        assert fa.flash_attention.launches > 0
    assert sum(g.replays for g in server.prefill_graphs.values()) == prefills - 3


def test_cpu_server_runs_eagerly():
    """The graph is asked for by default; on the CPU every step runs eagerly."""
    server, _ = _servers()
    assert server.cuda_graph is False
    server.serve(_requests(Request))
    assert server.graph is None and server.prefill_graphs == {}


def test_failed_capture_raises(monkeypatch):
    server, _ = _servers()
    _graphed(server, monkeypatch)

    def refuse(step):
        raise RuntimeError("operation not permitted when stream is capturing")

    monkeypatch.setattr(EagerGraph, "_record", lambda self, step: refuse(step))
    with pytest.raises(RuntimeError, match="capturing"):
        server.serve(_requests(Request))


class CountingGraph(serving.StepGraph):
    """A graph's launch semantics: during capture a wrapper's call is
    recorded and not run; a replay runs what was recorded."""

    def __init__(self):
        super().__init__(torch.device("cpu"))
        self.capturing = False
        self.recorded = []
        self.ran = {}

    def warm(self, step):
        return step()

    def _record(self, step):
        self.capturing = True
        try:
            return step()
        finally:
            self.capturing = False

    def _replay(self):
        for key in self.recorded:
            self.ran[key] = self.ran.get(key, 0) + 1


def test_counters_equal_the_launches_that_ran(monkeypatch):
    for wrapper, paths in ((fa.flash_attention, fa.PATHS), (ssd.mamba2_ssd, ssd.PATHS)):
        monkeypatch.setattr(wrapper, "launches", 0)
        monkeypatch.setattr(wrapper, "launches_by_path", {p: 0 for p in paths})
    graph = CountingGraph()

    def launch(wrapper, path):
        """A wrapper's call: counted as the wrapper counts it, run unless captured."""
        wrapper.launches += 1
        wrapper.launches_by_path[path] += 1
        key = (wrapper.__name__, path)
        if graph.capturing:
            graph.recorded.append(key)
        else:
            graph.ran[key] = graph.ran.get(key, 0) + 1

    def step():
        for _ in range(3):
            launch(fa.flash_attention, "split")
        launch(ssd.mamba2_ssd, "mma")
        return torch.zeros(1)

    def check():
        ran = {}
        for (name, path), n in graph.ran.items():
            ran.setdefault(name, {})[path] = n
        for wrapper in (fa.flash_attention, ssd.mamba2_ssd):
            want = ran.get(wrapper.__name__, {})
            assert wrapper.launches == sum(want.values())
            assert {p: n for p, n in wrapper.launches_by_path.items() if n} == want

    graph.warm(step)
    launch(fa.flash_attention, "mma")           # a prefill between the steps
    graph.capture(step)
    check()
    assert graph.launches == ((3, {"fma": 0, "mma": 0, "split": 3}), (1, {"fma": 0, "mma": 1}))
    for i in range(5):
        graph.replay()
        check()
        if i == 2:   # the counts are set to 0 between two replays, dicts replaced
            fa.flash_attention.launches = ssd.mamba2_ssd.launches = 0
            fa.flash_attention.launches_by_path = {p: 0 for p in fa.PATHS}
            ssd.mamba2_ssd.launches_by_path = {p: 0 for p in ssd.PATHS}
            graph.ran.clear()
    assert fa.flash_attention.launches == 6 and ssd.mamba2_ssd.launches == 2
    assert graph.replays == 5
