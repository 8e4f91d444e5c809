"""Trainer: step, checkpoint / restart, stragglers, meshes.

Counterpart of ``repro.runtime.trainer``:

* **the step** — ``Model.train_loss`` and its gradients by autograd, then
  :func:`repro_torch.optim.adamw_update` in place; with ``microbatches > 1``
  the batch is cut into that many row blocks whose gradients are summed in
  float32 and divided by their number (the reference's accumulation);
* **on a mesh** (``mesh=``, a ``DeviceMesh`` with axes ``data`` / ``model``
  and optionally ``pod``) — the parameters and moments are DTensors laid out
  by :func:`repro_torch.sharding.default_rules` (``fsdp`` shards the
  ``embed`` axis over the data axes too); each rank reads its rows of the
  global batch, gathers each layer's weights over the data axes where the
  layer reads them, computes its share of the products the rules shard
  over ``model`` (heads, ``ff``, experts, vocabulary) and the rest whole, on
  local tensors (:mod:`repro_torch.sharding`, "Running on a mesh"); each
  gradient comes back as this rank's block, summed over the data axes; the
  loss is the global mean, every rank's mean weighted by its share of the
  counted targets.  The update runs on each rank's blocks,
  the clipping norm over the whole mesh.  No op of the model goes through
  DTensor dispatch: the DTensors hold the state, local tensors do the work;
* **elastic rescale** — :meth:`Trainer.remesh` moves the trainer to another
  mesh (or to none); the next restore places the checkpoint's state on it;
* **checkpoint / restart** — periodic async checkpoints of the parameters,
  the optimizer state and the data cursor, in the reference's layout;
  ``run()`` survives injectable step failures by restoring the latest
  checkpoint and replaying the deterministic data stream;
* **stragglers** — per-step wall time through an EWMA + z-score detector; a
  slow step raises a counter and calls the callback;
* **preemption** — SIGTERM makes ``run()`` save synchronously and stop;
* **telemetry** — with :mod:`repro_torch.obs` on, the step records the spans
  ``train.forward`` (``Model.train_loss``), ``train.backward``
  (``torch.autograd.grad``, recomputation included) and ``train.optimizer``
  (the mesh's clipping norm and ``adamw_update``), one forward and one
  backward a microbatch; while a torch profiler records, each is a range on
  its trace.

A restart replays bit for bit only if every operation of the step is
deterministic: the embedding is looked up by ``F.embedding`` and the loss
is ``F.cross_entropy``, whose backwards on CUDA write each gradient once
(an indexing's or a gather's would add with atomics); the trainer does not
switch on ``torch.use_deterministic_algorithms``.  The MoE capacity path
replays bit for bit too (shown on an H100 at qwen2_moe_a2_7b's full width,
2 layers, 4,096 tokens a batch): its ``index_add_`` writes each kept slot
once, so the order of the atomic adds matters only in the drop bucket,
which is cut off.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import tempfile
import time
from typing import Any, Callable, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from .. import obs
from ..checkpoint import CheckpointManager
from ..data import DataConfig, SyntheticLM
from ..device import DeviceLike, resolve_device
from ..models import Model, ModelConfig, param_axes, param_shapes, split_products, transformer
from ..optim import AdamWConfig, adamw_init, adamw_update
from .. import sharding as shd

Params = Dict[str, torch.Tensor]
OptState = Dict[str, Any]

#: the attention paths that have a backward (the CUDA kernel is forward only)
TRAIN_ATTN_IMPLS = ("xla", "chunked")


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


def loss_and_grads(model: Model, params: Params, batch: Dict[str, torch.Tensor],
                   mesh=None, shardings=None) -> Tuple[torch.Tensor, Params]:
    """The loss of ``batch`` and its gradients (local blocks on a mesh)."""
    if mesh is None:
        with obs.span("train.forward"):
            loss = model.train_loss(batch)
        with obs.span("train.backward"):
            grads = torch.autograd.grad(loss, list(params.values()))
        return loss.detach(), dict(zip(params, grads))
    plan = shd.model_axis(split_products(model.cfg), shardings)
    with obs.span("train.forward"), model.bind(
            shd.gathered_tree(params, shardings, param_axes(model.cfg), plan), plan):
        loss = model.train_loss(batch)
    # the global mean: each rank's mean weighted by its share of the counted
    # targets (exactly 1.0 where one rank holds the batch)
    count = (batch["targets"] >= 0).sum()
    weight = count.float() / shd.all_reduce_data(count, mesh).clamp_min(1).float()
    loss = loss * weight
    with obs.span("train.backward"):
        grads = torch.autograd.grad(loss, list(params.values()))
    return shd.all_reduce_data(loss.detach(), mesh), {k: _local(g) for k, g in zip(params, grads)}


def _mesh_norm(grads: Params, shardings: Mapping[str, "shd.Sharding"], mesh) -> torch.Tensor:
    """The global norm of gradients held as blocks: each block's square sum
    over the ranks that hold a copy of it, summed over the mesh."""
    total = None
    for k, g in grads.items():
        sq = g.float().square().sum()
        n = shd.replicas(shardings[k])
        if n > 1:
            sq = sq / n
        total = sq if total is None else total + sq
    return torch.sqrt(shd.all_reduce_mesh(total, mesh))


def train_step(model: Model, opt_cfg: AdamWConfig, params: Params, opt_state: OptState,
               batch: Dict[str, torch.Tensor], microbatches: int = 1, mesh=None,
               shardings: Optional[Mapping[str, "shd.Sharding"]] = None
               ) -> Tuple[OptState, Dict[str, torch.Tensor]]:
    """One optimizer step of ``model`` on ``batch``; ``params`` and the moments
    are updated in place.  On a mesh ``params`` and the moments are DTensors
    laid out by ``shardings`` and ``batch`` is this rank's rows.  Returns the
    new optimizer state and the metrics (``loss``, ``grad_norm``, ``lr``).
    The trainer's step and the dry-run's."""
    mb = microbatches
    if mb > 1:
        n = next(iter(batch.values())).shape[0] // mb
        gsum = {k: torch.zeros(_local(p).shape, dtype=torch.float32, device=_local(p).device)
                for k, p in params.items()}
        losses = []
        for i in range(mb):
            loss, grads = loss_and_grads(model, params, {k: v[i * n:(i + 1) * n]
                                                         for k, v in batch.items()}, mesh,
                                         shardings)
            for k, g in grads.items():
                gsum[k].add_(g.float())
            losses.append(loss)
            del grads
        grads = {k: g.div_(mb) for k, g in gsum.items()}
        loss = torch.stack(losses).mean()
    else:
        loss, grads = loss_and_grads(model, params, batch, mesh, shardings)
    local_state = {"mu": {k: _local(m) for k, m in opt_state["mu"].items()},
                   "nu": {k: _local(m) for k, m in opt_state["nu"].items()},
                   "count": opt_state["count"]}
    with torch.no_grad():
        local_params = {k: _local(p) for k, p in params.items()}
    with obs.span("train.optimizer"):
        norm = None if mesh is None else _mesh_norm(grads, shardings, mesh)
        _, new, metrics = adamw_update(opt_cfg, local_params, grads, local_state, grad_norm=norm)
    metrics["loss"] = loss
    return {"mu": opt_state["mu"], "nu": opt_state["nu"], "count": new["count"]}, metrics


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
    for the CPU), or on ``mesh`` (this rank's device then; ``device`` is not
    read).  The parameters ask for gradients; the optimizer state is float32
    moments beside them."""

    def __init__(
        self,
        model_cfg: ModelConfig,
        opt_cfg: AdamWConfig,
        train_cfg: TrainConfig,
        data_cfg: DataConfig,
        device: DeviceLike = "cuda",
        straggler_callback: Optional[Callable[[int, float], None]] = None,
        mesh=None,
    ):
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
        # on a mesh, this rank's device (remesh sets it)
        self.device = resolve_device(device) if mesh is None else None
        self.detector = StragglerDetector(train_cfg.straggler_zscore, train_cfg.straggler_warmup)
        self.straggler_callback = straggler_callback
        self._preempted = False
        self.remesh(mesh)

    # -- state -----------------------------------------------------------------

    def init_state(self) -> Tuple[Params, OptState]:
        """Parameters drawn in place from ``cfg.seed`` (they ask for
        gradients) and a fresh optimizer state.  On a mesh every rank draws
        the whole model from the seed (the values the un-meshed trainer
        draws) and keeps its blocks as DTensors."""
        if self.mesh is None:
            self.model.init(seed=self.cfg.seed)
            params = dict(self.model.named_parameters())
            for p in params.values():
                p.requires_grad_(True)
            return params, adamw_init(params)
        full = Model(self.model_cfg, device=self.device).init(seed=self.cfg.seed)
        params = {k: shd.distribute(p.detach(), self._shardings[k]).requires_grad_(True)
                  for k, p in full.named_parameters()}
        del full

        def zeros(p):
            return DTensor.from_local(torch.zeros(p.to_local().shape, dtype=torch.float32,
                                                  device=self.device),
                                      p.device_mesh, p.placements, run_check=False)

        return params, {"mu": {k: zeros(p) for k, p in params.items()},
                        "nu": {k: zeros(p) for k, p in params.items()},
                        "count": torch.zeros((), dtype=torch.int32, device=self.device)}

    def param_shardings(self) -> Dict[str, "shd.Sharding"]:
        """Each parameter's :class:`~repro_torch.sharding.Sharding` on the
        trainer's mesh (keyed as the model's state dict)."""
        if self.mesh is None:
            raise ValueError("a trainer without a mesh has no shardings")
        return dict(self._shardings)

    # -- the step ----------------------------------------------------------------

    def _grads(self, params: Params, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Params]:
        return loss_and_grads(self.model, params, batch, self.mesh, self._shardings)

    def step(self, params: Params, opt_state: OptState,
             batch: Dict[str, torch.Tensor]) -> Tuple[OptState, Dict[str, torch.Tensor]]:
        """One optimizer step on ``batch`` (this rank's rows, on a mesh);
        ``params`` and the moments are updated in place.  Returns the new
        optimizer state and the metrics (``loss``, ``grad_norm``, ``lr``)."""
        return train_step(self.model, self.opt_cfg, params, opt_state, batch,
                          self.cfg.microbatches, self.mesh,
                          None if self.mesh is None else self._shardings)

    # -- data ------------------------------------------------------------------

    def _batches(self, start: int) -> Iterator[Tuple[int, Dict[str, np.ndarray]]]:
        pipe = SyntheticLM(self.data_cfg)
        i = start
        while True:
            yield i, pipe.batch(i)
            i += 1

    def _put_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """On a mesh, this rank's rows: of each microbatch (a block of
        ``global_batch / microbatches`` rows) the block its data coordinate
        names, as the reference's sharded reshape lays them out."""
        if self.mesh is not None:
            idx, n_data = shd.data_rank(self.mesh)
            mb = self.cfg.microbatches
            n = self.data_cfg.global_batch // mb
            rows = np.concatenate([np.arange(i * n + idx * n // n_data,
                                             i * n + (idx + 1) * n // n_data) for i in range(mb)])
            batch = {k: v[rows] for k, v in batch.items()}
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
                    self._sync()
                    params, opt_state = self.init_state()
                    step = 0
                    if self.ckpt.latest_step() is not None:
                        opt_state, step = self._restore(params, opt_state)
            self.ckpt.wait()
            self._sync()
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
        shardings = None
        if self.mesh is not None:
            ps = transformer.nest(self._shardings)
            shardings = {"params": ps, "opt": {"mu": ps, "nu": ps, "count": None}}
        state, extra = self.ckpt.restore(like, shardings=shardings)
        for part, target in (("params", like["params"]), ("opt", like["opt"])):
            _copy_tree(target, state[part])
        return opt_state, int(extra["data_index"])

    # -- elastic -----------------------------------------------------------------

    def remesh(self, new_mesh) -> None:
        """Move to ``new_mesh`` (a ``DeviceMesh``, or ``None`` for this
        trainer's one device): new rules, shardings and model; the next
        restore (``run()`` restores the latest checkpoint) places the state
        on the new layout, whatever mesh wrote it."""
        cfg = self.model_cfg
        self.mesh = new_mesh
        if new_mesh is None:
            if self.cfg.fsdp:
                raise ValueError("fsdp shards the parameters over a mesh: pass mesh=")
            self.rules, self._shardings = None, None
        else:
            self.device = shd.Sharding(new_mesh, ()).device
            self.rules = shd.default_rules(new_mesh, n_experts=cfg.moe.n_experts if cfg.moe else 0,
                                           fsdp=self.cfg.fsdp)
            shapes = {k: torch.empty(s, device="meta") for k, s in param_shapes(cfg).items()}
            self._shardings = shd.logical_to_sharding(param_axes(cfg), new_mesh, self.rules,
                                                      like=shapes)
        # on a mesh the model holds no weights: each step binds the gathered ones
        self.model = Model(cfg, attn_impl=self.cfg.attn_impl, ssd_impl="chunked",
                           device=self.device, remat=self.cfg.remat,
                           storage="meta" if new_mesh is not None else None)
        writer = new_mesh is None or new_mesh.get_rank() == 0
        self.ckpt = CheckpointManager(self.cfg.checkpoint_dir, keep=self.cfg.keep_checkpoints,
                                      writer=writer)

    def _sync(self) -> None:
        """On a mesh, wait for every rank (rank 0 may still be renaming a
        checkpoint that the others are about to read)."""
        if self.mesh is not None:
            shd.all_reduce_mesh(torch.zeros(1, device=self.device), self.mesh)

    def _on_sigterm(self, signum, frame):  # pragma: no cover - signal path
        self._preempted = True


def _copy_tree(dst: Any, src: Any) -> None:
    if isinstance(dst, dict):
        for k in dst:
            _copy_tree(dst[k], src[k])
    else:
        _local(dst).copy_(_local(src))
