"""What every cell shares: finding its files by name, the weights drawn from
the seed, the program's configuration held to the configuration file, and
the run's record.

Everything of one configuration, cell, traffic kind or per-layer metric is
a file of its own that is found by the name in ``BENCHMARK.json``:

* ``gpubench/configs/<config>.json``
* ``gpubench/workloads/<cell>.json`` (its ``kind`` names the traffic)
* ``gpubench/traffic/<kind>.py``, a ``Driver`` class
* ``gpubench/metrics/<metric>.py``, a ``read(run)`` function
"""

from __future__ import annotations

import dataclasses
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


# -- the program's side ----------------------------------------------------------


def port_config(run: Run):
    """The program's configuration that the file names, held field by field
    to the file's sizes: a later change to the program's configs cannot
    change what a cell runs unseen."""
    from repro_torch.configs import base

    port = run.config["port_config"]
    name = run.config["rehearsal"]["port_config"] if run.rehearse else port
    cfg = base.reduced_config(port) if run.rehearse else base.get_config(port)
    d = run.dims
    got = {"n_layers": cfg.n_layers, "d_model": cfg.d_model, "n_heads": cfg.n_heads,
           "n_kv_heads": cfg.n_kv_heads, "head_dim": cfg.dh, "d_ff": cfg.d_ff, "vocab": cfg.vocab,
           "rope_theta": cfg.rope_theta, "qkv_bias": cfg.qkv_bias,
           "dtype": str(cfg.dtype).replace("torch.", "")}
    if cfg.moe is not None:
        m = cfg.moe
        got["moe"] = {"n_experts": m.n_experts, "top_k": m.top_k, "d_ff_expert": m.d_ff_expert,
                      "d_ff_shared": m.d_ff_shared, "shared_gate": m.shared_gate,
                      "norm_topk": m.norm_topk, "capacity_factor": m.capacity_factor}
    want = {k: d[k] for k in got}
    if want.get("moe"):
        want["moe"] = {k: d["moe"][k] for k in got["moe"]}
    if got != want or cfg.name != name or cfg.tie_embeddings or cfg.global_period != 1:
        raise SystemExit(f"the program's {name} is not the configuration file's: {got} != {want}")
    return cfg


def draw_weights(dims: Dict, seed: int, device) -> Dict[str, Any]:
    """Every leaf of :func:`reference.model.layout`, drawn on ``device`` in
    the served type: each leaf in one call from a generator of its own,
    seeded from ``(seed, leaf)``, so that any leaf can be drawn again alone."""
    import torch

    from gpubench.reference import model as ref

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
