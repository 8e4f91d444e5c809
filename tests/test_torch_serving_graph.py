"""The port's ``Server`` with its decode step captured as a CUDA graph, on the CPU.

A CUDA graph exists only on the card, so these tests drive the Server's
graph path through a stand-in for :class:`repro_torch.runtime.serving.StepGraph`
that has a graph's effects: the warm-up runs the step, the capture runs it
for its output alone (the Server's state is put back, as a capture leaves it
untouched), and a replay runs the step again and writes its output where the
capture's was.  What runs is the exact function the Server hands to the
capture.  Seven reduced configs cover the families the Server serves; weights
and requests are those of ``tests/test_torch_serving.py``.

* the captured step reads nothing back to the host (a function mode that
  raises on every such call, with ``attn_impl="chunked"``: the kernel's plain
  version reads ``u.any()``, and the card never runs it);
* its tokens and logits equal the eager Server's bit for bit, and follow the
  reference's ``Server.serve`` (float32 logits within ``test_torch_serving``'s
  1e-4 a step: the dense family's KV cache is bfloat16 in either package,
  and over ten steps a key rounds an ulp apart there, 9.3e-5 at most);
* the host's mirror of the positions raises the cache-overflow
  ``ValueError`` before a step would write past the cache, for busy and
  free slots alike;
* the state buffers live as long as the Server;
* the launch counters equal the launches that ran through capture and replay.
"""

import re

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from repro.runtime.serving import Request as JRequest
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import mamba2_ssd as ssd
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


class EagerGraph(serving.StepGraph):
    """The stand-in for the CUDA graph (see the module's docstring)."""

    def __init__(self, server, guard):
        super().__init__(server.device)
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
        leaves = _leaves(self.server._state)
        saved = [t.clone() for t in leaves]
        self.step, self.out = step, self._guarded(step)
        for t, s in zip(leaves, saved):
            t.copy_(s)
        self.captures += 1
        return self.out

    def _replay(self):
        self.out.copy_(self._guarded(self.step))


def _graphed(server, monkeypatch, guard=False):
    """``server`` on the graph path, through the stand-in."""
    server.cuda_graph = True
    monkeypatch.setattr(serving, "StepGraph", lambda device: EagerGraph(server, guard))
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
    its third decode step.  A free slot: prompts of 2 and 5 tokens end
    together after 3 steps, the third request takes slot 0 at position 2 and
    slot 1, free, stands at 8: the next step would write past the end there.
    Both raise before the step, with the message of the model's own check,
    and the state stays as it was."""
    def server():
        s, _ = _servers(max_len=8)
        return _graphed(s, monkeypatch) if graph else s

    busy = server()
    calls = _spied(busy, monkeypatch)
    with pytest.raises(ValueError, match=re.escape(
            "KV cache of length 8 cannot take 1 token(s) starting at positions 8..8")):
        busy.serve([Request(uid=0, prompt=np.arange(1, 7, dtype=np.int32))])
    assert busy._state["pos"].tolist() == [8, 8]
    assert len(calls) == (3 if graph else 2)    # warm-up, capture, replay: no fourth call

    free = server()
    calls = _spied(free, monkeypatch)
    lengths = (2, 5, 2)
    with pytest.raises(ValueError, match=re.escape(
            "KV cache of length 8 cannot take 1 token(s) starting at positions 2..8")):
        free.serve([Request(uid=i, prompt=np.arange(1, n + 1, dtype=np.int32))
                    for i, n in enumerate(lengths)])
    assert free._state["pos"].tolist() == [2, 8]
    assert free._positions.tolist() == [2, 8]
    assert len(calls) == (4 if graph else 3)
    if graph:   # the captured step skips the model's check: the mirror holds it
        assert calls == [False] * 4
    # the model's own check raises the same error on the eager step
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


def test_cpu_server_runs_eagerly():
    """The graph is asked for by default; on the CPU every step runs eagerly."""
    server, _ = _servers()
    assert server.cuda_graph is False
    server.serve(_requests(Request))
    assert server.graph is None


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
