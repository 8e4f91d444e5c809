"""Batched serving runtime: prefill + decode with continuous batching.

Counterpart of ``repro.runtime.serving``.  A small but real serving loop:

* fixed-size decode batch with **slot recycling** (continuous batching):
  when a sequence finishes (EOS or max tokens), its slot is refilled from
  the request queue with a fresh prefill, whose state is written into the
  shared KV cache at that slot;
* every slot, busy or free, is decoded each step; the first prefill is
  broadcast into all slots so that free slots hold a valid state, and a free
  slot's insert past the cache's end is clamped into it, as the reference's
  is (its output is never read);
* greedy or temperature sampling (the draw is numpy's, on the host, so that
  the same seed picks the same tokens as the reference given equal logits).

The reference jits its decode step into one compiled program, and its
prefill into one a prompt length.  Here, on a CUDA device, both are captured
as CUDA graphs and replayed (``cuda_graph``, on by default; :class:`StepGraph`).
The decode step is captured once per ``Server``: the first step of the
Server's life runs eagerly on the stream the capture uses, the second is
captured and replayed, and every later step copies the tokens in, replays,
and samples from the graph's logits on the host.  Prefill is captured once a
prompt length: the first prefill of a length runs eagerly on the prefill
graphs' stream and is then captured, every later one copies the prompt in
and replays.  The prefill graphs share one stream and one memory pool, and
each writes its logits and one-sequence state into the same Server-owned
buffers: what else a prefill allocates is freed when its capture ends, so
the pool holds about one prefill's temporaries, not one a length.  A capture
that has to grow the pool found no free block the size of one of its
temporaries (a mixture of experts' exact path, below 257 tokens, makes ones
that grow with the prompt): every prefill graph is then captured again,
longest prompt first, into a new pool, so that the shorter prompts'
temporaries fit in the longer ones' blocks.  On the CPU every step runs
eagerly.  The slot state is updated **in place** (``_set_slot``, the KV
insert of ``transformer.block``), where the reference builds new arrays, and
it lives as long as the Server: each ``serve`` call broadcasts its first
prefill into the same buffers, so one capture serves every call.  A graph
cannot raise, so the Server checks a prompt's length and keeps each busy
slot's position on the host, and raises the cache-overflow ``ValueError``
before the step, on either path.

With telemetry on (:mod:`repro_torch.obs`) the Server records its phases as
spans on the host, around its calls and graph replays, never inside a
captured step (a span there would run once, at capture): ``serve`` (a call),
``serve.prefill`` (a prompt's prefill, first sight and capture included),
``serve.decode`` (a decode step, its room check included), ``serve.sample``
(sampling and the copy to the host), ``serve.slot_copy`` (a prefill's state
written into one slot, or broadcast into all) and ``graph.capture`` (a
:class:`StepGraph` capture).  Its counters: ``serve.prefill_tokens`` (prompt
tokens prefilled), ``serve.decode_rows`` (the rows the decode steps
computed), ``serve.busy_rows`` (those of them that held a request), and
for the models that keep SSM states ``serve.ssd_scan_tokens`` (prompt
tokens times layers: the rows the prefills' SSD scans walked) and what the
kernels publish (:func:`repro_torch.kernels.telemetry_counts`: the SSD
kernel's launches by plan, ``ssd.launches.<path>.p<p_block>``, which a
replayed graph keeps true).  All are ticked on the host, so they hold whether a
prefill ran eagerly or as a graph.
While a torch profiler records, each span is also a range on its trace.
"""

from __future__ import annotations

import dataclasses
import queue
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from .. import obs
from ..device import DeviceLike, resolve_device
from ..models import (
    Model, ModelConfig, add_launches, launch_counts, launches_since, param_dtypes,
    telemetry_counts,
)
from ..models.transformer import check_room
from ..obs import Histogram

State = Dict[str, Any]


class StepGraph:
    """A step function captured once as a CUDA graph and replayed: the
    counterpart of the reference's ``jax.jit`` for a step of fixed shapes.

    :meth:`warm` runs the step eagerly on the side stream that the capture
    will use (kernels loaded, the attention's split tickets allocated, the
    library's handles made for that stream); :meth:`capture` records it, and
    raises if the step cannot be captured; :meth:`replay` runs what it
    recorded.  What the step returned at capture is where every replay
    writes its output.  The kernel wrappers count their Python calls, so
    capture raises their counters for launches that did not run and a
    replay raises none: :meth:`capture` takes back what it added and
    :meth:`replay` adds what one replay launches, counter by counter
    (``launches``, :func:`repro_torch.kernels.launches_since`), so that
    every counter equals the launches that ran.  ``capture_seconds`` (the
    seconds of every capture of the graph) and ``pool_bytes`` (the memory
    the last capture added to the graph's pool) are set by the capture.

    A graph whose ``share`` is another graph uses that graph's stream and
    memory pool.  Graphs that share a pool may reuse each other's
    temporaries, so a replay must not read what another graph of the pool
    left there: each must return only tensors made outside its capture."""

    def __init__(self, device: torch.device, share: Optional["StepGraph"] = None):
        self.device = device
        self.share = share
        self.stream: Optional[torch.cuda.Stream] = None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.launches: Optional[Dict] = None    # what one replay launches
        self.replays = 0
        self.capture_seconds: Optional[float] = None
        self.pool_bytes: Optional[int] = None

    def warm(self, step: Callable[[], Any]) -> Any:
        self.stream = (self.share.stream if self.share is not None
                       else torch.cuda.Stream(self.device))
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            out = step()
        current.wait_stream(self.stream)
        return out

    def capture(self, step: Callable[[], Any]) -> Any:
        with obs.span("graph.capture"):
            before = launch_counts()
            out = self._record(step)
            self.launches = launches_since(before)
            add_launches(self.launches, -1)
        return out

    def replay(self) -> None:
        self._replay()
        add_launches(self.launches, 1)
        self.replays += 1

    def _record(self, step: Callable[[], Any]) -> Any:
        # not through torch.cuda.graph, which empties the allocator's cache
        # first: every eager step after it would allocate its memory anew.
        # The graph's pool takes segments of its own, so the reserved memory
        # grows by what the capture added to the pool.
        torch.cuda.synchronize(self.device)
        reserved = torch.cuda.memory_reserved(self.device)
        t0 = time.perf_counter()
        self.graph = torch.cuda.CUDAGraph()
        pool = None if self.share is None else self.share.graph.pool()
        with torch.cuda.stream(self.stream):
            self.graph.capture_begin(pool=pool)
            try:
                out = step()
            finally:
                self.graph.capture_end()
        self.capture_seconds = (self.capture_seconds or 0.0) + time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        return out

    def _replay(self) -> None:
        self.graph.replay()


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    batch_slots: int = 8
    max_len: int = 512
    max_new_tokens: int = 32
    eos: int = 0
    temperature: float = 0.0
    seed: int = 0


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray  # (prompt_len,) int32


@dataclasses.dataclass
class Completion:
    uid: int
    tokens: List[int]
    latency_s: float


class Server:
    """Single-device server.  ``params`` is a state dict in the reference's
    key names (``Model.state_dict()`` or :func:`repro_torch.convert.params_from_reference`);
    its tensors are adopted, not copied, when they already lie on ``device``
    in the dtype the model declares for them (:func:`repro_torch.models.param_dtypes`).
    The model is built without storage of its own (``storage="meta"``), so
    the weights are never held twice.
    Attention goes through ``attn_impl`` and the SSD scan of the ssm and
    hybrid families through ``ssd_impl``: the CUDA kernels by default, which
    on CPU tensors are their plain versions.

    ``cuda_graph`` (the reference's jit; on by default) captures the decode
    step once as a CUDA graph and replays it (:class:`StepGraph`,
    ``self.graph`` from the first decode step on), and the prefill once a
    prompt length (``self.prefill_graphs``, by length, kept for the Server's
    life; captured anew, longest first, when a capture grows their pool:
    ``self.prefill_recaptures``); off, every step runs eagerly, as it always
    does on the CPU.
    Nothing is allocated before the first ``serve``."""

    def __init__(
        self, model_cfg: ModelConfig, cfg: ServeConfig, params: Mapping[str, torch.Tensor],
        device: DeviceLike = "cuda", attn_impl: str = "hopper", ssd_impl: str = "hopper",
        cuda_graph: bool = True,
    ):
        self.device = resolve_device(device)
        self.model = Model(model_cfg, attn_impl=attn_impl, ssd_impl=ssd_impl, device=self.device,
                           storage="meta")
        dtypes = param_dtypes(model_cfg)
        adopted = {
            name: t.detach().to(device=self.device, dtype=dtypes.get(name, model_cfg.dtype))
            for name, t in params.items()
        }
        self.model.load_state_dict(adopted, assign=True)
        self.cfg = cfg
        self.cuda_graph = cuda_graph and self.device.type == "cuda"
        self.graph: Optional[StepGraph] = None
        self.prefill_graphs: Dict[int, StepGraph] = {}
        self.prefill_recaptures = 0     # times the prefill graphs were captured anew
        # every slot's decode state, the graph's input tokens and its logits,
        # each prefill graph's prompt, and the logits and one-sequence state
        # that every prefill graph writes: made at first use, then kept for
        # the Server's life
        self._state: Optional[State] = None
        self._graph_tokens: Optional[torch.Tensor] = None
        self._graph_logits: Optional[torch.Tensor] = None
        self._prefill_tokens: Dict[int, torch.Tensor] = {}
        self._prefill_out: Optional[Tuple[torch.Tensor, State]] = None
        # the host's mirror of state["pos"], and which slots hold a request
        self._positions = np.zeros(cfg.batch_slots, np.int64)
        self._busy = np.zeros(cfg.batch_slots, bool)
        # serve-level metrics: always on (one histogram append per finished sequence)
        self._latency_ms = Histogram()
        self._tokens_done = 0
        self._busy_seconds = 0.0

    def metrics_snapshot(self) -> dict:
        """Serving health as one plain dict: completion latency distribution
        (p50/p99) and lifetime decode throughput."""
        return {
            "completions": self._latency_ms.count,
            "tokens": self._tokens_done,
            "tokens_per_s": round(
                self._tokens_done / self._busy_seconds, 3
            ) if self._busy_seconds else 0.0,
            "latency_ms": self._latency_ms.snapshot(),
        }

    # -- steps ---------------------------------------------------------------------

    def _prefill(self, tokens: torch.Tensor):
        """The logits and one-sequence state of the prompt ``tokens (1, L)``.
        A graph cannot raise, so a prompt longer than the cache raises here,
        on the host, before anything runs."""
        leaves = self.model.family.STATE
        if "kv" in leaves:
            check_room(0, 0, tokens.shape[1], self.cfg.max_len)
        before = launch_counts() if obs.enabled() else None
        with obs.span("serve.prefill"):
            out = self._graph_prefill(tokens) if self.cuda_graph else self._prefill_step(tokens)
        if before is not None:
            reg = obs.metrics()
            reg.counter("serve.prefill_tokens").inc(tokens.shape[1])
            if "ssm" in leaves:
                reg.counter("serve.ssd_scan_tokens").inc(tokens.shape[1] * self.model.cfg.n_layers)
            for name, n in telemetry_counts(launches_since(before)).items():
                reg.counter(name).inc(n)
        return out

    def _prefill_step(self, tokens: torch.Tensor, out: Optional[State] = None):
        """The prefill, reading nothing back to the host (the room is
        checked before it); its state made anew, or written into ``out``."""
        h, state = self.model.prefill({"tokens": tokens}, self.cfg.max_len, check_room=False,
                                      out=out)
        return self.model.logits(h[:, -1:])[:, 0], state

    def _graph_prefill(self, tokens: torch.Tensor):
        """A prompt length's first prefill eagerly on the prefill graphs'
        stream, then captured; every later one replayed into the Server's
        one-sequence buffers (read before the next prefill: sampling and the
        slot's copy)."""
        length = tokens.shape[1]
        graph = self.prefill_graphs.get(length)
        if graph is not None:
            self._prefill_tokens[length].copy_(tokens)
            graph.replay()
            return self._prefill_out
        static = tokens.clone()
        graph = StepGraph(self.device, share=next(iter(self.prefill_graphs.values()), None))
        out = graph.warm(lambda: self._prefill_step(static))
        if self._prefill_out is None:
            self._prefill_out = (torch.empty_like(out[0]),
                                 self._map_state(lambda x, ax: torch.empty_like(x), out[1]))
        graph.capture(lambda: self._prefill_into(static))
        self.prefill_graphs[length] = graph
        self._prefill_tokens[length] = static
        if graph.pool_bytes and graph.share is not None:
            self._recapture_prefills()
        return out

    def _recapture_prefills(self):
        """Every prefill graph captured again, longest prompt first, into a
        new pool that the first one owns; the old pool is released first (no
        replay is in flight: the capture that asks for this synchronised the
        card)."""
        graphs = sorted(self.prefill_graphs.items(), reverse=True)
        for _, graph in graphs:
            graph.graph = None
        torch.cuda.empty_cache()
        self.prefill_recaptures += 1
        for i, (length, graph) in enumerate(graphs):
            graph.share = graphs[0][1] if i else None
            graph.capture(lambda static=self._prefill_tokens[length]: self._prefill_into(static))
        self.prefill_graphs = dict(graphs)

    def _prefill_into(self, tokens: torch.Tensor):
        """The step a prefill graph holds: the prefill written into the
        Server's one-sequence buffers, which it returns, so that all else it
        allocates is freed when its capture ends."""
        logits, _ = self._prefill_step(tokens, out=self._prefill_out[1])
        self._prefill_out[0].copy_(logits)
        return self._prefill_out

    def _decode(self, tokens: torch.Tensor, state: State):
        """One decode step of every slot: ``state`` (the Server's own) is
        updated in place and handed back with the step's logits."""
        with obs.span("serve.decode"):
            busy = self._positions[self._busy]
            if "kv" in state and busy.size:  # a graph cannot raise: the host's mirror is checked
                check_room(int(busy.min()), int(busy.max()), 1, state["kv"][0].shape[2])
            logits = self._graph_decode(tokens) if self.cuda_graph else self._step(tokens)
        self._positions += 1
        if obs.enabled():
            reg = obs.metrics()
            reg.counter("serve.decode_rows").inc(tokens.shape[0])
            reg.counter("serve.busy_rows").inc(busy.size)
        return logits, state

    def _graph_decode(self, tokens: torch.Tensor) -> torch.Tensor:
        """The first step of the Server's life eagerly on the capture's
        stream, the second captured and replayed, every later one replayed."""
        if self._graph_tokens is None:
            self._graph_tokens = torch.empty_like(tokens)
        self._graph_tokens.copy_(tokens)
        if self.graph is None:
            self.graph = StepGraph(self.device)
            return self.graph.warm(self._graph_step)
        if self._graph_logits is None:
            self._graph_logits = self.graph.capture(self._graph_step)
        self.graph.replay()
        return self._graph_logits

    def _graph_step(self) -> torch.Tensor:
        """The step that the graph holds: on the graph's tokens."""
        return self._step(self._graph_tokens)

    def _step(self, tokens: torch.Tensor) -> torch.Tensor:
        """``tokens`` against the Server's state, which is updated in place
        (``pos`` too); returns the logits.  Nothing is read back to the host:
        the room is checked on the host's mirror before the step."""
        h, new_state = self.model.decode_step(tokens, self._state, check_room=False)
        self._state["pos"].copy_(new_state["pos"])
        return self.model.logits(h[:, -1:])[:, 0]

    def _sample(self, logits: torch.Tensor, rng: np.random.Generator) -> np.ndarray:
        with obs.span("serve.sample"):
            if self.cfg.temperature <= 0.0:
                return logits.argmax(dim=-1).cpu().numpy()
            probs = torch.softmax(logits / self.cfg.temperature, dim=-1).float().cpu().numpy()
        return np.array(
            [rng.choice(probs.shape[-1], p=probs[i]) for i in range(probs.shape[0])]
        )

    def _tokens(self, host: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(host)).to(self.device)

    # -- the serving loop ------------------------------------------------------------

    def serve(self, requests: List[Request]) -> List[Completion]:
        t_call = time.perf_counter()
        with obs.span("serve", requests=len(requests)) as sp:
            done = self._serve(requests)
            sp.set(completions=len(done))
        self._busy_seconds += time.perf_counter() - t_call
        for c in done:
            self._latency_ms.observe(c.latency_s * 1e3)
            self._tokens_done += len(c.tokens)
        return done

    def _serve(self, requests: List[Request]) -> List[Completion]:
        cfg = self.cfg
        rng = np.random.default_rng(cfg.seed)
        pending: "queue.SimpleQueue[Request]" = queue.SimpleQueue()
        for r in requests:
            pending.put(r)

        # state per slot
        slot_req: List[Optional[Request]] = [None] * cfg.batch_slots
        slot_tokens: List[List[int]] = [[] for _ in range(cfg.batch_slots)]
        slot_start: List[float] = [0.0] * cfg.batch_slots
        done: List[Completion] = []

        state: Optional[State] = None
        next_tokens = np.zeros((cfg.batch_slots,), np.int32)

        def fill_slot(slot: int):
            nonlocal state
            if pending.empty():
                slot_req[slot] = None
                self._busy[slot] = False
                return
            req = pending.get()
            slot_req[slot] = req
            self._busy[slot] = True
            slot_tokens[slot] = []
            slot_start[slot] = time.perf_counter()
            logits, st = self._prefill(self._tokens(req.prompt[None, :]))  # (1, L)
            tok = int(self._sample(logits, rng)[0])
            with obs.span("serve.slot_copy"):
                if state is None:
                    # this call's first fill: broadcast into every slot
                    state = self._fill_all(st, len(req.prompt))
                else:
                    self._map_state2(
                        lambda full, one, ax: self._set_slot(full, one, slot, ax), state, st
                    )
                    self._positions[slot] = len(req.prompt)
            slot_tokens[slot].append(tok)
            next_tokens[slot] = tok

        for slot in range(cfg.batch_slots):
            fill_slot(slot)

        while any(r is not None for r in slot_req):
            logits, state = self._decode(self._tokens(next_tokens)[:, None], state)
            sampled = self._sample(logits, rng)
            for slot, req in enumerate(slot_req):
                if req is None:
                    continue
                tok = int(sampled[slot])
                slot_tokens[slot].append(tok)
                next_tokens[slot] = tok
                if tok == cfg.eos or len(slot_tokens[slot]) >= cfg.max_new_tokens:
                    done.append(
                        Completion(
                            uid=req.uid,
                            tokens=list(slot_tokens[slot]),
                            latency_s=time.perf_counter() - slot_start[slot],
                        )
                    )
                    fill_slot(slot)
        return sorted(done, key=lambda c: c.uid)

    # -- slot surgery ------------------------------------------------------------------
    # State leaves keyed by their top-level name:
    #   kv:   (L or apps, B, S, H, Dh) x2   -> batch axis 1
    #   ssm:  (L, B, H, P, N)               -> batch axis 1
    #   conv: (L, B, D_CONV-1, conv_dim)    -> batch axis 1
    #   pos:  (B,)                          -> batch axis 0
    # (the dense, moe and vlm families hold kv and pos; enc keeps the
    # reference's axis for the family to come)
    _BATCH_AXIS = {"kv": 1, "ssm": 1, "conv": 1, "pos": 0, "enc": 0}

    @classmethod
    def _map_state(cls, fn, state: State) -> State:
        out: State = {}
        for key, leaf in state.items():
            ax = cls._BATCH_AXIS.get(key, 0)
            out[key] = tuple(fn(x, ax) for x in leaf) if isinstance(leaf, tuple) else fn(leaf, ax)
        return out

    @classmethod
    def _map_state2(cls, fn, full: State, one: State) -> None:
        for key, leaf in full.items():
            ax = cls._BATCH_AXIS.get(key, 0)
            if isinstance(leaf, tuple):
                for a, b in zip(leaf, one[key]):
                    fn(a, b, ax)
            else:
                fn(leaf, one[key], ax)

    def _fill_all(self, one: State, length: int) -> State:
        """Writes ``one`` (the prefill state of one sequence, or of every
        slot) into every slot of the Server's state, **in place**, and sets
        every slot's position to ``length``; the state is made at first
        use."""
        if self._state is None:
            slots = self.cfg.batch_slots
            self._state = self._map_state(
                lambda x, ax: x.new_empty(x.shape[:ax] + (slots,) + x.shape[ax + 1:]), one)
        self._map_state2(lambda full, o, ax: full.copy_(o), self._state, one)
        self._positions[:] = length
        return self._state

    @staticmethod
    def _set_slot(full: torch.Tensor, one: torch.Tensor, slot: int, ax: int) -> None:
        """Writes the one-sequence leaf into ``full`` at ``slot``, **in place**
        (the reference returns a new array)."""
        full.narrow(ax, slot, 1).copy_(one)
