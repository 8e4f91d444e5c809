"""Single-device trainer: step, checkpoint / restart, stragglers.

Counterpart of ``repro.runtime.trainer`` on one device, without a mesh:

* **the step** — ``Model.train_loss`` and its gradients by autograd, then
  :func:`repro_torch.optim.adamw_update` in place; with ``microbatches > 1``
  the batch is cut into that many row blocks whose gradients are summed in
  float32 and divided by their number (the reference's accumulation);
* **checkpoint / restart** — periodic async checkpoints of the parameters,
  the optimizer state and the data cursor, in the reference's layout;
  ``run()`` survives injectable step failures by restoring the latest
  checkpoint and replaying the deterministic data stream;
* **stragglers** — per-step wall time through an EWMA + z-score detector; a
  slow step raises a counter and calls the callback;
* **preemption** — SIGTERM makes ``run()`` save synchronously and stop.

A restart replays bit for bit only if every operation of the step is
deterministic: the embedding is looked up by ``F.embedding`` and the loss
is ``F.cross_entropy``, whose backwards on CUDA write each gradient once
(an indexing's or a gather's would add with atomics); the trainer does not
switch on ``torch.use_deterministic_algorithms``.  The MoE capacity path
(``index_add_``, an indexing backward) is not deterministic on CUDA.

What needs more than one device — ``fsdp``, ``remesh`` and restoring onto
another layout — comes with the sharding slice of the port (ROADMAP A10)
and raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import tempfile
import time
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ..checkpoint import CheckpointManager
from ..data import DataConfig, SyntheticLM
from ..device import DeviceLike, resolve_device
from ..models import Model, ModelConfig, transformer
from ..optim import AdamWConfig, adamw_init, adamw_update

Params = Dict[str, torch.Tensor]
OptState = Dict[str, Any]

#: the attention paths that have a backward (the CUDA kernel is forward only)
TRAIN_ATTN_IMPLS = ("xla", "chunked")
_LATER = "comes with the sharding slice of the port (ROADMAP A10)"


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The reference's fields.  ``checkpoint_every`` 0 writes no checkpoint
    at all (not even the final one)."""

    steps: int = 100
    microbatches: int = 1          # gradient accumulation
    checkpoint_every: int = 50
    checkpoint_dir: str = dataclasses.field(
        default_factory=lambda: os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    keep_checkpoints: int = 3
    log_every: int = 10
    seed: int = 0
    fsdp: bool = False
    remat: str = "none"
    attn_impl: str = "chunked"
    straggler_zscore: float = 3.0
    straggler_warmup: int = 8


class StragglerDetector:
    """EWMA + z-score over per-step wall time."""

    def __init__(self, z_threshold: float, warmup: int):
        self.z = z_threshold
        self.warmup = warmup
        self.mean = 0.0
        self.var = 0.0
        self.n = 0
        self.flagged = 0

    def observe(self, dt: float) -> bool:
        self.n += 1
        if self.n == 1:
            # the first step carries one-off set-up (allocation, library
            # handles); it would poison the steady-state statistics
            return False
        if self.n <= self.warmup + 1:
            # prime the statistics
            k = self.n - 1
            self.mean += (dt - self.mean) / k
            self.var += ((dt - self.mean) ** 2 - self.var) / k
            return False
        std = max(self.var**0.5, 1e-9)
        is_straggler = (dt - self.mean) / std > self.z
        alpha = 0.05
        self.mean += alpha * (dt - self.mean)
        self.var += alpha * ((dt - self.mean) ** 2 - self.var)
        if is_straggler:
            self.flagged += 1
        return is_straggler


class Trainer:
    """Trains ``model_cfg`` on ``device`` (the GPU unless the caller asks
    for the CPU).  The model's parameters are turned to ask for gradients;
    the optimizer state is float32 moments beside them."""

    def __init__(
        self,
        model_cfg: ModelConfig,
        opt_cfg: AdamWConfig,
        train_cfg: TrainConfig,
        data_cfg: DataConfig,
        device: DeviceLike = "cuda",
        straggler_callback: Optional[Callable[[int, float], None]] = None,
    ):
        if train_cfg.fsdp:
            raise NotImplementedError(f"fsdp {_LATER}")
        if train_cfg.attn_impl not in TRAIN_ATTN_IMPLS:
            raise ValueError(
                f"training runs attention through {TRAIN_ATTN_IMPLS}, not "
                f"{train_cfg.attn_impl!r}: the CUDA kernel has no backward")
        if train_cfg.microbatches < 1 or data_cfg.global_batch % train_cfg.microbatches:
            raise ValueError("microbatches must divide the global batch")
        self.model_cfg = model_cfg
        self.opt_cfg = opt_cfg
        self.cfg = train_cfg
        self.data_cfg = data_cfg
        self.device = resolve_device(device)
        self.model = Model(model_cfg, attn_impl=train_cfg.attn_impl, ssd_impl="chunked",
                           device=self.device, remat=train_cfg.remat)
        self.detector = StragglerDetector(train_cfg.straggler_zscore, train_cfg.straggler_warmup)
        self.straggler_callback = straggler_callback
        self.ckpt = CheckpointManager(train_cfg.checkpoint_dir, keep=train_cfg.keep_checkpoints)
        self._preempted = False

    # -- state -----------------------------------------------------------------

    def init_state(self) -> Tuple[Params, OptState]:
        """Parameters drawn in place from ``cfg.seed`` (they ask for
        gradients) and a fresh optimizer state."""
        self.model.init(seed=self.cfg.seed)
        params = dict(self.model.named_parameters())
        for p in params.values():
            p.requires_grad_(True)
        return params, adamw_init(params)

    # -- the step ----------------------------------------------------------------

    def _grads(self, params: Params, batch: Dict[str, torch.Tensor]):
        loss = self.model.train_loss(batch)
        grads = torch.autograd.grad(loss, list(params.values()))
        return loss.detach(), dict(zip(params, grads))

    def step(self, params: Params, opt_state: OptState,
             batch: Dict[str, torch.Tensor]) -> Tuple[OptState, Dict[str, torch.Tensor]]:
        """One optimizer step on ``batch``; ``params`` and the moments are
        updated in place.  Returns the new optimizer state and the metrics
        (``loss``, ``grad_norm``, ``lr``)."""
        mb = self.cfg.microbatches
        if mb > 1:
            n = next(iter(batch.values())).shape[0] // mb
            gsum = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                    for k, p in params.items()}
            losses = []
            for i in range(mb):
                loss, grads = self._grads(params, {k: v[i * n:(i + 1) * n]
                                                   for k, v in batch.items()})
                for k, g in grads.items():
                    gsum[k].add_(g.float())
                losses.append(loss)
                del grads
            grads = {k: g.div_(mb) for k, g in gsum.items()}
            loss = torch.stack(losses).mean()
        else:
            loss, grads = self._grads(params, batch)
        _, opt_state, metrics = adamw_update(self.opt_cfg, params, grads, opt_state)
        metrics["loss"] = loss
        return opt_state, metrics

    # -- data ------------------------------------------------------------------

    def _batches(self, start: int) -> Iterator[Tuple[int, Dict[str, np.ndarray]]]:
        pipe = SyntheticLM(self.data_cfg)
        i = start
        while True:
            yield i, pipe.batch(i)
            i += 1

    def _put_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(v).to(self.device) for k, v in batch.items()}

    # -- the run loop (fault-tolerant) -------------------------------------------

    def run(
        self,
        fault_injector: Optional[Callable[[int], None]] = None,
        max_restarts: int = 3,
    ) -> Dict[str, Any]:
        """Train for ``cfg.steps`` with checkpoint / restart fault tolerance.

        ``fault_injector(step)`` may raise to simulate a node failure; the
        loop draws the parameters afresh, restores the last checkpoint (if
        any) and continues, replaying the deterministic data stream.  Returns
        ``losses`` (every step run, replays included), ``final_step``,
        ``restarts``, ``stragglers``, ``params``, ``opt_state`` and
        ``step_seconds`` (each step's wall time, the injector's included)."""
        try:
            old_handler = signal.signal(signal.SIGTERM, self._on_sigterm)
        except ValueError:  # not on the main thread
            old_handler = None

        try:
            restarts = 0
            params, opt_state = self.init_state()
            step = 0
            if self.ckpt.latest_step() is not None:
                opt_state, step = self._restore(params, opt_state)
            losses, seconds = [], []
            while step < self.cfg.steps:
                try:
                    for step, host_batch in self._batches(step):
                        if step >= self.cfg.steps or self._preempted:
                            break
                        t0 = time.perf_counter()
                        if fault_injector is not None:
                            # inside the timed region: injected stalls register
                            # on the straggler detector like real slow nodes
                            fault_injector(step)
                        opt_state, metrics = self.step(params, opt_state,
                                                       self._put_batch(host_batch))
                        loss = float(metrics["loss"])
                        dt = time.perf_counter() - t0
                        self._observe_step(step, dt)
                        losses.append(loss)
                        seconds.append(dt)
                        nxt = step + 1
                        every = self.cfg.checkpoint_every
                        if every and (nxt % every == 0 or nxt == self.cfg.steps):
                            self._save(nxt, params, opt_state)
                        step = nxt
                    if self._preempted:
                        self._save(step, params, opt_state, async_=False)
                        break
                except Exception:
                    restarts += 1
                    if restarts > max_restarts:
                        raise
                    # an async save still in flight is the checkpoint to resume
                    # from: without the wait it is a .tmp directory, and the run
                    # would start again from step 0 (the reference does not wait)
                    self.ckpt.wait()
                    params, opt_state = self.init_state()
                    step = 0
                    if self.ckpt.latest_step() is not None:
                        opt_state, step = self._restore(params, opt_state)
            self.ckpt.wait()
        finally:
            if old_handler is not None:
                signal.signal(signal.SIGTERM, old_handler)
        return {
            "losses": losses,
            "final_step": step,
            "restarts": restarts,
            "stragglers": self.detector.flagged,
            "params": {k: p.detach() for k, p in params.items()},
            "opt_state": opt_state,
            "step_seconds": seconds,
        }

    def _observe_step(self, step: int, dt: float) -> None:
        """Straggler pipeline: detector -> mitigation callback."""
        if self.detector.observe(dt) and self.straggler_callback:
            self.straggler_callback(step, dt)

    # -- checkpoint plumbing -------------------------------------------------------

    @staticmethod
    def _tree(params: Params, opt_state: OptState) -> Dict[str, Any]:
        """The reference's checkpoint tree: ``params`` and ``opt`` (``mu``,
        ``nu``, ``count``), each parameter tree nested as the reference's."""
        return {"params": transformer.nest(params),
                "opt": {"mu": transformer.nest(opt_state["mu"]),
                        "nu": transformer.nest(opt_state["nu"]),
                        "count": opt_state["count"]}}

    def _save(self, step: int, params: Params, opt_state: OptState, async_: bool = True) -> None:
        self.ckpt.save(step, self._tree(params, opt_state), extra={"data_index": step},
                       async_=async_)

    @torch.no_grad()
    def _restore(self, params: Params, opt_state: OptState) -> Tuple[OptState, int]:
        """The latest checkpoint copied into ``params`` and ``opt_state`` in
        place; returns the optimizer state and the data cursor."""
        like = self._tree(params, opt_state)
        state, extra = self.ckpt.restore(like)
        for part, target in (("params", like["params"]), ("opt", like["opt"])):
            _copy_tree(target, state[part])
        return opt_state, int(extra["data_index"])

    # -- elastic -----------------------------------------------------------------

    def remesh(self, new_mesh: Any) -> None:
        raise NotImplementedError(f"remesh (elastic rescale) {_LATER}")

    def _on_sigterm(self, signum, frame):  # pragma: no cover - signal path
        self._preempted = True


def _copy_tree(dst: Any, src: Any) -> None:
    if isinstance(dst, dict):
        for k in dst:
            _copy_tree(dst[k], src[k])
    else:
        dst.copy_(src)
