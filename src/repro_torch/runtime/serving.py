"""Batched serving runtime: prefill + decode with continuous batching.

Counterpart of ``repro.runtime.serving``.  A small but real serving loop:

* fixed-size decode batch with **slot recycling** (continuous batching):
  when a sequence finishes (EOS or max tokens), its slot is refilled from
  the request queue with a fresh prefill, whose state is written into the
  shared KV cache at that slot;
* every slot, busy or free, is decoded each step; the first prefill is
  broadcast into all slots so that free slots hold a valid state;
* greedy or temperature sampling (the draw is numpy's, on the host, so that
  the same seed picks the same tokens as the reference given equal logits).

The reference jits its two step functions; PyTorch runs them eagerly.  The
slot state is updated **in place** (``_set_slot``, the KV insert of
``transformer.block``), where the reference builds new arrays.
"""

from __future__ import annotations

import dataclasses
import queue
import time
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch

from .. import obs
from ..device import DeviceLike, resolve_device
from ..models import Model, ModelConfig, param_dtypes
from ..obs import Histogram

State = Dict[str, Any]


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
    on CPU tensors are their plain versions."""

    def __init__(
        self, model_cfg: ModelConfig, cfg: ServeConfig, params: Mapping[str, torch.Tensor],
        device: DeviceLike = "cuda", attn_impl: str = "hopper", ssd_impl: str = "hopper",
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
        h, state = self.model.prefill({"tokens": tokens}, self.cfg.max_len)
        return self.model.logits(h[:, -1:])[:, 0], state

    def _decode(self, tokens: torch.Tensor, state: State):
        h, new_state = self.model.decode_step(tokens, state)
        return self.model.logits(h[:, -1:])[:, 0], new_state

    def _sample(self, logits: torch.Tensor, rng: np.random.Generator) -> np.ndarray:
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
        seconds = time.perf_counter() - t_call
        self._busy_seconds += seconds
        for c in done:
            self._latency_ms.observe(c.latency_s * 1e3)
            self._tokens_done += len(c.tokens)
        if obs.enabled():
            reg = obs.metrics()
            reg.counter("serve.completions").inc(len(done))
            reg.histogram("serve.batch_s").observe(seconds)
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
                return
            req = pending.get()
            slot_req[slot] = req
            slot_tokens[slot] = []
            slot_start[slot] = time.perf_counter()
            logits, st = self._prefill(self._tokens(req.prompt[None, :]))  # (1, L)
            tok = int(self._sample(logits, rng)[0])
            if state is None:
                # first fill: broadcast single-slot state into the batch
                state = self._map_state(
                    lambda x, ax: x.repeat_interleave(cfg.batch_slots, dim=ax), st
                )
            else:
                self._map_state2(
                    lambda full, one, ax: self._set_slot(full, one, slot, ax), state, st
                )
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

    @staticmethod
    def _set_slot(full: torch.Tensor, one: torch.Tensor, slot: int, ax: int) -> None:
        """Writes the one-sequence leaf into ``full`` at ``slot``, **in place**
        (the reference returns a new array)."""
        full.narrow(ax, slot, 1).copy_(one)
