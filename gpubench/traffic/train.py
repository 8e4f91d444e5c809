"""Training: the program's ``Trainer.step`` on one packed row a step.

Set-up builds the one training object (the ``Trainer`` with its model, the
parameters drawn from the seed and copied into it, AdamW's state), drives
it through its first ``warm_steps`` steps through the same call and feed as
the window (rows ``0, 1, 2`` of the seed's data, all different), and keeps
what the check compares: each step's loss, the first step's gradient norm
by leaf (worked out from Adam's first moment after one step and the step's
reported clipping norm), and each leaf's change after the last of them.
The window then runs further steps on further rows, and ends with
``torch.cuda.synchronize()`` after its last step.

The check, once the window has closed and the program's state is freed:
the plain float32 reference trains the same weights (drawn again from the
seed) on the same rows, and each number is the worst leaf's gap between
the program's norm and the reference's, against the larger of the
reference's norm of that leaf and of the median leaf.  A leaf whose
reference gradient is under a thousandth of the median leaf's moves by
round-off alone and is left out of the change.
"""

from __future__ import annotations

import contextlib
import gc
import statistics
import time
from typing import Dict, List, Tuple

from gpubench import harness
from gpubench.reference import no_tf32
from gpubench.reference import train as ref_train
from gpubench.traffic.synthetic_lm import SyntheticLM


def worst_leaf(got: Dict[str, float], want: Dict[str, float], leaves) -> float:
    """The worst gap of ``got`` against ``want`` over ``leaves``, each against
    the larger of its own reference norm and the median leaf's."""
    med = statistics.median(want.values())
    return max(abs(got[k] - want[k]) / max(want[k], med) for k in leaves)


def counted(grad: Dict[str, float]) -> List[str]:
    """Leaves whose reference gradient is not nought to rounding."""
    med = statistics.median(grad.values())
    return [k for k, g in grad.items() if g >= 1e-3 * med]


class Driver:
    def __init__(self, run: harness.Run):
        self.run = run
        self.p = run.params
        self.ref = harness.reference(run)
        self.trainer = None
        self.losses = []

    def setup(self) -> None:
        import torch
        from repro_torch.data import DataConfig
        from repro_torch.optim import AdamWConfig, adamw_init
        from repro_torch.runtime.trainer import TrainConfig, Trainer

        run, t = self.run, self.p["train"]
        dev = run.device
        cfg = harness.port_config(run)
        self.opt = t["optimizer"]
        self.trainer = Trainer(
            cfg, AdamWConfig(**self.opt),
            TrainConfig(steps=1 << 30, microbatches=t["microbatches"], checkpoint_every=0,
                        remat=t["remat"], attn_impl=t["attn_impl"], seed=0),
            DataConfig(vocab=cfg.vocab, seq_len=t["seq_len"], global_batch=t["rows"]),
            device=dev)
        self.params = dict(self.trainer.model.named_parameters())
        parts = run.record.setdefault("setup_parts", {})
        t0 = time.perf_counter()
        with torch.no_grad():
            for name, w in harness.draw_weights(run.dims, run.seed, dev, self.ref).items():
                self.params[name].copy_(w)
                del w
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        for p in self.params.values():
            p.requires_grad_(True)
        self.state = adamw_init(self.params)
        self.data = SyntheticLM(cfg.vocab, t["seq_len"], t["rows"], run.seed % (1 << 63),
                                t["mean_doc_len"])
        self.index = 0
        rec = run.record
        rec["losses"] = []
        for i in range(t["warm_steps"]):
            met = self._step(None)
            rec["losses"].append(float(met["loss"]))
            if i == 0:
                gnorm = float(met["grad_norm"])
                scale = min(1.0, self.opt["grad_clip"] / max(gnorm, 1e-9))
                b1 = self.opt["b1"]
                rec["first_grad"] = {k: float(m.norm()) / (1 - b1) / scale
                                     for k, m in self.state["mu"].items()}
        rec["change"] = self._change()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        parts.update({"weights_s": t1 - t0, "warm_s": time.perf_counter() - t1})

    def _step(self, tracer):
        import torch

        span = tracer.span if tracer is not None else (lambda _: contextlib.nullcontext())
        with span("gpubench.batch_upload"):
            host = self.data.batch(self.index)
            batch = {k: torch.from_numpy(v).to(self.run.device) for k, v in host.items()}
        with span("gpubench.step"):
            self.state, met = self.trainer.step(self.params, self.state, batch)
        self.index += 1
        return met

    def _change(self) -> Dict[str, float]:
        """Each leaf's change from its drawn value, drawn again leaf by leaf."""
        import torch

        out = {}
        with torch.no_grad():
            for i, (name, (shape, std)) in enumerate(self.ref.layout(self.run.dims).items()):
                p = self.params[name]
                p0 = harness.draw_leaf(shape, std, self.run.seed, i, p.device, p.dtype)
                out[name] = float((p.float() - p0.float()).norm())
                del p0
        return out

    def window(self, seconds: float, tracer) -> None:
        import torch

        first = self.index
        tokens = self.p["train"]["seq_len"] * self.p["train"]["rows"]
        calls = []
        start = time.perf_counter()
        while time.perf_counter() - start < seconds:
            phase = tracer.boundary(time.perf_counter() - start)
            t0 = time.perf_counter()
            self.losses.append(self._step(tracer)["loss"])
            calls.append((phase, time.perf_counter() - t0, tokens))
        if self.run.device.type == "cuda":
            torch.cuda.synchronize()
        rec = self.run.record
        rec["window_s"] = time.perf_counter() - start
        rec["steps"] = self.index - first
        # the steps the profiler recorded: what the traced window's metrics count
        rec["steps_traced"] = sum(1 for c in calls if c[0] == "on")
        rec["tokens_per_step"] = tokens
        rec["window_losses"] = [float(x) for x in self.losses]
        rec["calls"] = calls

    def release(self) -> None:
        import torch

        self.trainer = self.params = self.state = None
        self.losses = []
        gc.collect()
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    def counts(self) -> Tuple[int, int]:
        """(attempted, failed): a step fails where its loss is not finite."""
        import math

        losses = self.run.record["window_losses"]
        return len(losses), sum(1 for x in losses if not math.isfinite(x))

    def end_to_end(self) -> Dict[str, float]:
        rec = self.run.record
        return {"train_tokens_per_s": rec["steps"] * rec["tokens_per_step"] / rec["window_s"]}

    def reference(self, precision: str = "fp32", drop_half: bool = False) -> Dict:
        """The float32 reference's (or the control's) first ``warm_steps``
        steps from the seed's weights on the seed's rows: losses, first
        gradient by leaf, change by leaf.  ``drop_half`` plants a fault: the
        second half of each row's targets left out, the mean over the rest."""
        import torch

        run, t = self.run, self.p["train"]
        dims, dev = run.dims, run.device
        if t["rows"] != 1:
            raise ValueError("the reference trains on one row a step")
        params = {k: w.float()
                  for k, w in harness.draw_weights(dims, run.seed, dev, self.ref).items()}
        data = SyntheticLM(dims["vocab"], t["seq_len"], t["rows"], run.seed % (1 << 63),
                           t["mean_doc_len"])
        batches = []
        for i in range(t["warm_steps"]):
            b = {k: torch.from_numpy(v[0]).to(dev) for k, v in data.batch(i).items()}
            if drop_half:
                b["targets"][t["seq_len"] // 2:] = -1
            batches.append(b)
        got = ref_train.run_steps(dims, self.opt, params, batches, precision, self.ref)
        change = {}
        with torch.no_grad():
            for i, (name, (shape, std)) in enumerate(self.ref.layout(dims).items()):
                p0 = harness.draw_leaf(shape, std, run.seed, i, dev, getattr(torch, dims["dtype"]))
                change[name] = float((params[name] - p0.float()).norm())
        return {"losses": got["losses"], "first_grad": got["first_grad"], "change": change}

    @staticmethod
    def compare(got: Dict, want: Dict) -> Dict[str, float]:
        """The three numbers of ``got`` (the program's or a control's) against
        ``want`` (the float32 reference's)."""
        loss = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"]))
        grad = worst_leaf(got["first_grad"], want["first_grad"], want["first_grad"])
        change = worst_leaf(got["change"], want["change"], counted(want["first_grad"]))
        return {"loss_gap": loss, "grad_gap": grad, "change_gap": change}

    def check(self) -> Dict[str, Tuple[float, float]]:
        no_tf32()
        rec = self.run.record
        got = self.compare(rec, self.reference())
        rec["loss_gap"] = got["loss_gap"]   # read, not compared (PERF.md says why)
        lim = self.p["check"]
        _, failed = self.counts()
        return {**{k: (v, lim[f"{k}_limit"]) for k, v in got.items() if f"{k}_limit" in lim},
                "failed_steps": (failed, 0)}
