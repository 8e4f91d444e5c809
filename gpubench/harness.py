"""What every cell shares: finding its files by name, the weights drawn from
the seed, the program's configuration held to the configuration file, and
the run's record.

Everything of one configuration, cell, traffic kind or per-layer metric is
a file of its own that is found by the name in ``BENCHMARK.json``:

* ``gpubench/configs/<config>.json``
* ``gpubench/reference/<reference>.py``, the module the configuration's
  ``reference`` key names (:func:`reference`)
* ``gpubench/workloads/<cell>.json`` (its ``kind`` names the traffic)
* ``gpubench/traffic/<kind>.py``, a ``Driver`` class
* ``gpubench/metrics/<metric>.py``, a ``read(run)`` function

A reference module is the yardstick of one model family, in plain PyTorch,
importing nothing of the program.  Each function takes ``run``, the
configuration's ``run`` block (its ``rehearsal`` one on the CPU):

* ``layout(run)``: ``{name: (shape, std)}`` of every leaf, in drawing order
  (leaf ``i`` is drawn from a generator seeded from its index,
  :func:`draw_leaf`).  The names are the program's parameter names, which the
  ``Server`` and the ``Trainer`` adopt.
* ``served_logits(run, leaf, seqs, precision)``: for each ``(tokens,
  prompt_len)`` of ``seqs``, the float32 logits at the positions whose
  argmax the program served; ``leaf(name, layer)`` gives the weights, and
  ``precision="fp8"`` is the control.
* ``train_loss(run, params, tokens, targets, precision)``: the mean
  next-token loss of one row, for a configuration with a training cell.
* ``body_params(run, active=True)`` and ``head_params(run)``: the
  parameters of the products a token passes through (the routed experts it
  takes, or with ``active`` False all of them) and of the head.
* ``attention_layers(run)``: ``(Hq, Hkv, Dh)`` of each layer application
  that attends causally over the whole sequence.
* optionally ``token_flops(run)``: the forward pass's further work a token
  that is no product and no attention (a state-space scan), 0 without it.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional

GPUBENCH = Path(__file__).resolve().parent
#: the checkout's root: ``BENCHMARK.json`` and the program's ``src/``
ROOT = GPUBENCH.parent
#: top-level module names a run may not load: JAX and the JAX package,
#: compared as whole names (``repro_torch`` is the program, not ``repro``)
BANNED = ("jax", "jaxlib", "flax", "repro")
#: the reference of a bare ``run`` block that no configuration file names
#: one for (the yardstick's own tests): the dense and MoE families'
DEFAULT_REFERENCE = "model"


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str) -> ModuleType:
    """A file of the benchmark as a module of its own (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(f"gpubench_file.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def banned_modules() -> List[str]:
    """The top-level names in ``sys.modules`` that a run may not load."""
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(BANNED))


@dataclasses.dataclass
class Run:
    """One run of one cell: its entries and files, its arguments, and what
    its driver recorded (``record``) and its trace read (``trace``)."""

    bench: Dict
    cell: Dict
    workload: Dict
    config: Dict
    seed: int
    traced: bool
    rehearse: bool
    device: Any = None
    record: Dict = dataclasses.field(default_factory=dict)
    trace: Any = None

    @property
    def dims(self) -> Dict:
        """The configuration's sizes as run (the rehearsal's on the CPU)."""
        return self.config["rehearsal"]["run"] if self.rehearse else self.config["run"]

    @property
    def params(self) -> Dict:
        """The workload's parameters as run (its ``rehearsal`` block over them)."""
        p = {k: v for k, v in self.workload.items() if k != "rehearsal"}
        if self.rehearse:
            p.update(self.workload.get("rehearsal", {}))
        return p

    def metrics(self, section: str) -> List[Dict]:
        """The cell's metrics of ``end_to_end`` or ``per_layer``: those that
        list it, or list no cells."""
        name = self.cell["name"]
        return [m for m in self.bench[section] if name in m.get("workloads", [name])]


def open_run(root: Path, workload: str, seed: int, traced: bool, rehearse: bool) -> Run:
    bench = load_json(root / "BENCHMARK.json")
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no cell {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    wl = load_json(GPUBENCH / "workloads" / f"{workload}.json")
    config = load_json(GPUBENCH / "configs" / f"{cell['config']}.json")
    if wl["config"] != cell["config"] or wl["kind"] != cell["traffic"]:
        raise SystemExit(f"{workload}: the workload file names {wl['config']} / {wl['kind']}, "
                         f"BENCHMARK.json {cell['config']} / {cell['traffic']}")
    return Run(bench, cell, wl, config, seed, traced, rehearse)


def driver(run: Run):
    kind = run.workload["kind"]
    return load_module(GPUBENCH / "traffic" / f"{kind}.py", kind).Driver(run)


def reader(name: str):
    return load_module(GPUBENCH / "metrics" / f"{name}.py", name).read


def reference(run: Run) -> ModuleType:
    """The reference module the configuration file names."""
    return reference_module(run.config["reference"])


@functools.lru_cache(maxsize=None)
def reference_module(name: str) -> ModuleType:
    """``gpubench/reference/<name>.py``, loaded once a process."""
    return load_module(GPUBENCH / "reference" / f"{name}.py", f"reference.{name}")


# -- the program's side ----------------------------------------------------------


#: each key of a configuration file's ``run`` block that shapes the work, and
#: the attribute of the program's ``ModelConfig`` it is held to
FIELDS = {"n_layers": "n_layers", "d_model": "d_model", "n_heads": "n_heads",
          "n_kv_heads": "n_kv_heads", "head_dim": "dh", "d_ff": "d_ff", "vocab": "vocab",
          "rope_theta": "rope_theta", "qkv_bias": "qkv_bias", "dtype": "dtype", "moe": "moe",
          "tie_embeddings": "tie_embeddings", "global_period": "global_period",
          "window": "window", "attn_chunk": "attn_chunk", "nope_on_global": "nope_on_global",
          "local_rope_theta": "local_rope_theta", "mrope": "mrope", "ssm_state": "ssm_state",
          "ssm_heads": "ssm_heads", "ssm_head_dim": "ssm_head_dim", "ssm_chunk": "ssm_chunk",
          "attn_period": "attn_period"}
#: the keys of the ``moe`` group, each the ``MoEConfig`` attribute of its name
MOE_FIELDS = ("n_experts", "top_k", "d_ff_expert", "d_ff_shared", "shared_gate", "norm_topk",
              "capacity_factor")


def _plain(value):
    """A program's field as a configuration file states it."""
    import torch

    if dataclasses.is_dataclass(value):   # the MoE group
        return {k: getattr(value, k) for k in MOE_FIELDS}
    if isinstance(value, torch.dtype):
        return str(value).replace("torch.", "")
    return value


def port_config(run: Run):
    """The program's configuration that the file names, held to the file: its
    name and ``family``, and each field of :data:`FIELDS` equal to the ``run``
    block's where the block states it, and at the field's default where it
    does not.  A later change to the program's configs cannot change what a
    cell runs unseen."""
    from repro_torch.configs import base

    port = run.config["port_config"]
    name = run.config["rehearsal"]["port_config"] if run.rehearse else port
    cfg = base.reduced_config(port) if run.rehearse else base.get_config(port)
    defaults = {f.name: f.default for f in dataclasses.fields(cfg)}
    d = run.dims
    got = {"name": cfg.name, "family": cfg.family}
    want = {"name": name, "family": run.config["family"]}
    for key, attr in FIELDS.items():
        if key in d:
            got[key] = _plain(getattr(cfg, attr))
            want[key] = ({k: d[key].get(k) for k in MOE_FIELDS} if key == "moe" and d[key]
                         else d[key])
        else:
            got[key], want[key] = _plain(getattr(cfg, key)), _plain(defaults[key])
    if got != want:
        diff = {k: (got[k], want[k]) for k in got if got[k] != want[k]}
        raise SystemExit(f"the program's {cfg.name} is not the configuration file's "
                         f"(program, file): {diff}")
    return cfg


def draw_weights(dims: Dict, seed: int, device, ref: Optional[ModuleType] = None
                 ) -> Dict[str, Any]:
    """Every leaf of the reference module ``ref``'s layout, drawn on ``device``
    in the served type: each leaf in one call from a generator of its own,
    seeded from ``(seed, leaf)``, so that any leaf can be drawn again alone."""
    import torch

    ref = ref or reference_module(DEFAULT_REFERENCE)
    dtype = getattr(torch, dims["dtype"])
    out = {}
    for i, (name, (shape, std)) in enumerate(ref.layout(dims).items()):
        out[name] = draw_leaf(shape, std, seed, i, device, dtype)
    return out


def draw_leaf(shape, std: float, seed: int, index: int, device, dtype):
    """Leaf ``index`` of the layout, from its own generator on ``device``."""
    import torch

    gen = torch.Generator(device=device).manual_seed(
        (seed * 0x9E3779B97F4A7C15 + (index + 1) * 0xBF58476D1CE4E5B9) % (1 << 63))
    return torch.empty(shape, dtype=dtype, device=device).normal_(0.0, std, generator=gen)


def leaf_reader(weights: Dict[str, Any]):
    """``leaf(name, layer)`` of the reference: float32 copies, one layer's at a time."""
    def leaf(name: str, layer: Optional[int]):
        w = weights[name] if layer is None else weights[name][layer]
        return w.float()
    return leaf
