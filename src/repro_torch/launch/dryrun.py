"""Dry-run: every (arch x shape x mesh) cell's step on ``meta`` tensors.

Counterpart of ``repro.launch.dryrun``.  The reference lowers and compiles
each cell's step on a 512-device host platform and reads XLA's analyses; the
port runs the step itself, eagerly, on rank 0 of the mesh with ``meta``
tensors (shapes and dtypes, no storage, no arithmetic), and counts what it
dispatches:

* ``flops`` — **per device**: ``FlopCounterMode`` over rank 0's local
  tensors.  The port computes on local tensors: a rank's rows of the batch
  and, on the ``model`` axis, its share of each product the rules shard
  there, in every family (whole heads, ``ff``, its experts or its part of
  ``ff_expert``, a mamba layer's SSM heads, its rows of the vocabulary;
  :mod:`repro_torch.sharding`), the rest whole (attention where
  ``n_heads`` does not divide the axis, as whisper's 20 heads on 16; a
  vocabulary the axis does not divide, as mamba2's and whisper's on 16;
  the router; a mamba layer's ``B`` / ``C`` columns).  So this is the work
  of one device; counted on DTensors it would be the global figure;
* ``bytes_accessed`` — the input and output bytes of every aten op on the
  local tensors (views excluded: they move nothing).  In eager PyTorch every
  op reads and writes device memory, so this is the un-fused step's traffic;
* ``memory`` (per device) — ``argument_bytes``: parameters, optimizer state
  and inputs by their placements; ``temp_bytes``: the peak of the ``meta``
  storages the step holds live at once (what it allocates beyond its
  arguments: gathered weights, activations, gradients); ``output_bytes``:
  what it returns that is not an argument; ``alias_bytes``: what it returns
  that is (the parameters and moments, updated in place);
* ``placements`` (the port's addition) — the spec of every argument leaf
  that is sharded, by name (``params``, ``state`` of a decode cell);
* ``collectives`` — ``bytes_by_type``, ``counts``, ``total_bytes`` and
  ``wire_bytes`` of the functional collectives the step issues
  (``torch.ops._c10d_functional``), read from each one's tensors, with the
  reference's ring formulas: the gathers of the weights over the data axes
  (fsdp) and, over ``model``, of the leaves whose product stays whole and of
  the leaves a rank reads in pieces (a mamba layer's ``in_proj`` / ``conv``,
  whose ``B`` / ``C`` columns every rank reads); the all-reduces that sum a
  split region's parts (activations forward, their gradients backward, the
  gated norm's sums of squares both ways); the gradients' reduce-scatters
  over the data axes.
  On the ``1gpu`` mesh every axis is 1 wide, no collective is issued, and
  every figure is 0.

The meshes: ``single`` (16x16), ``multi`` (2x16x16), ``both``, and ``1gpu``,
the card's own one-rank mesh.  All are built over a fake process group
(:func:`repro_torch.launch.mesh.fake_mesh`), so the dry-run runs in a process
of its own.  Prefill and decode cells use ``attn_impl="chunked"``, as the
reference does: the CUDA kernels cannot run on ``meta``.  A decode cell's
cache comes in the layout of :func:`repro_torch.launch.specs.state_shardings`;
where the plan splits the heads a rank keeps (or, from a cache whose
sequence the rules shard, cuts) the K / V heads it computes and, in a mamba
stack, the SSM heads of its state; its conv state is gathered and cut to
its channels (its heads' ``x`` and all of ``B`` / ``C``, which the rules'
cut of ``conv_dim`` crosses).  After the step the state goes back to the
rules' blocks: the ranks' heads and ``x`` channels gathered over ``model``
where the block is not the rank's own, then cut.  Its greedy token is the
argmax across the vocabulary's shards.  A cell that fails is
recorded with ``status: "error"`` and its message; the sweep goes on.

Usage::

    python -m repro_torch.launch.dryrun --arch qwen2_7b --shape train_4k
    python -m repro_torch.launch.dryrun --all --mesh both --out dryrun.json
    python -m repro_torch.launch.dryrun --arch stablelm_3b --shape train_4k --mesh 1gpu \\
        --seq-len 512 --global-batch 8 --remat none,dots,full --microbatches 1,4
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
import weakref
from typing import Any, Dict, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from ..configs import ARCH_IDS, ShapeCell, get_config, shape_cells
from ..models import Model, rank_state, split_products, state_heads_dim, whole_state
from ..models.common import unrolled_scans
from ..optim import AdamWConfig
from ..runtime.trainer import train_step
from ..sharding import (
    Sharding, check_divisibility, default_rules, gathered_tree, logical_to_sharding, model_axis,
    reshard, unshard,
)
from . import specs
from .mesh import make_dryrun_mesh

_COLLECTIVES = (
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
    "collective-permute",
)
#: ``_c10d_functional`` op -> the reference's collective name
_FUNCTIONAL = {
    "all_gather_into_tensor": "all-gather", "reduce_scatter_tensor": "reduce-scatter",
    "all_reduce": "all-reduce", "all_to_all_single": "all-to-all",
}
MESH_NAMES = {"single": ["16x16"], "multi": ["2x16x16"], "both": ["16x16", "2x16x16"],
              "1gpu": ["1gpu"]}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _group_size(name: str) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group

    return _resolve_process_group(name).size()


class StepTrace(TorchDispatchMode):
    """What a step dispatches on plain (local) tensors: bytes read and
    written by every op that is not a view, the live storages it allocates
    (their peak), and each functional collective's bytes.  ``arguments`` are
    the step's own tensors: an op that writes one in place (or views it)
    allocates nothing."""

    def __init__(self, arguments=()):
        super().__init__()
        self.arguments = {t.untyped_storage()._cdata for t in arguments}
        self.bytes = 0
        self.live: Dict[int, list] = {}
        self.now = self.peak = 0
        self.per_op = {c: 0 for c in _COLLECTIVES}
        self.counts = {c: 0 for c in _COLLECTIVES}
        self.wire = 0.0

    def _release(self, key: int) -> None:
        entry = self.live[key]
        entry[1] -= 1
        if entry[1] == 0:
            self.now -= entry[0]
            del self.live[key]

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self.arguments:
            return
        if key not in self.live:
            self.live[key] = [st.nbytes(), 0]
            self.now += st.nbytes()
            self.peak = max(self.peak, self.now)
        self.live[key][1] += 1
        weakref.finalize(t, self._release, key)

    def _collective(self, name: str, args) -> None:
        coll = _FUNCTIONAL.get(name)
        if coll is None:
            return
        size = _nbytes(args[0])
        # (input, group_size, name), (input, op, group_size, name), (input, op, name),
        # (input, output_splits, input_splits, name)
        g = max(1, _group_size(args[-1]))
        self.counts[coll] += 1
        self.per_op[coll] += size                      # the operand
        if coll == "all-gather":
            self.wire += size * g * (g - 1) / g        # the result is g operands
        elif coll == "all-reduce":
            self.wire += 2 * size * (g - 1) / g
        else:                                          # reduce-scatter, all-to-all
            self.wire += size * (g - 1) / g

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.namespace == "_c10d_functional":
            self._collective(func._opname, args)
        elif not func.is_view:
            self.bytes += sum(_nbytes(t) for t in tree_leaves((args, kwargs, out))
                              if isinstance(t, torch.Tensor))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._track(t)
        return out

    def collectives(self) -> Dict[str, Any]:
        return {"bytes_by_type": dict(self.per_op), "counts": dict(self.counts),
                "total_bytes": sum(self.per_op.values()), "wire_bytes": int(self.wire)}


# ---------------------------------------------------------------------------
# Step builders
# ---------------------------------------------------------------------------


def _meta_like(t: torch.Tensor, dtype=None) -> torch.Tensor:
    return torch.empty(t.shape, dtype=dtype or t.dtype, device="meta")


def build_cell(
    arch: str,
    cell: ShapeCell,
    mesh,
    *,
    remat: str = "full",
    fsdp: bool = True,
    attn_impl: str = "chunked",
    microbatches: int = 1,
    extra_rules=None,
) -> Tuple[Any, Tuple, Tuple]:
    """Returns ``(step_fn, abstract_args, in_shardings)``: the step takes rank
    0's local blocks of the abstract (global, ``meta``) arguments, laid out by
    the shardings."""
    cfg = get_config(arch)
    model = Model(cfg, attn_impl=attn_impl, remat=remat, device="meta")
    rules = extra_rules or default_rules(
        mesh, n_experts=(cfg.moe.n_experts if cfg.moe else 0), fsdp=fsdp and cell.kind == "train"
    )
    params_struct, axes = model.abstract_init()
    p_shard = logical_to_sharding(axes, mesh, rules, like=params_struct)
    g = specs.cell_geometry(cfg, cell)

    if cell.kind == "train":
        opt_struct = {"mu": {k: _meta_like(p, torch.float32) for k, p in params_struct.items()},
                      "nu": {k: _meta_like(p, torch.float32) for k, p in params_struct.items()},
                      "count": torch.empty((), dtype=torch.int32, device="meta")}
        opt_shard = {"mu": p_shard, "nu": p_shard, "count": Sharding(mesh, ())}
        ocfg = AdamWConfig()

        def step(params, opt_state, batch):
            opt_state, metrics = train_step(model, ocfg, params, opt_state, batch, microbatches,
                                            mesh, p_shard)
            return params, opt_state, metrics

        batch = specs.train_inputs(cfg, cell)
        b_shard = specs.batch_shardings(mesh, batch, g["batch"])
        return step, (params_struct, opt_struct, batch), (p_shard, opt_shard, b_shard)

    plan = model_axis(split_products(cfg), p_shard)
    if cell.kind == "prefill":
        @torch.no_grad()
        def prefill_step(params, batch):
            # the state stays as computed (this rank's rows, whole): the
            # reference gives its prefill no output shardings either
            with model.bind(gathered_tree(params, p_shard, axes, plan), plan):
                h, state = model.prefill(batch, max_len=g["seq"])
                tokens = model.greedy(h[:, -1:])
            return tokens, state

        batch = specs.prefill_inputs(cfg, cell)
        b_shard = specs.batch_shardings(mesh, batch, g["batch"])
        return prefill_step, (params_struct, batch), (p_shard, b_shard)

    # decode
    tok_struct, state_struct = specs.decode_inputs(cfg, cell)
    tok_shard = specs.batch_shardings(mesh, tok_struct, g["batch"])
    st_shard = specs.state_shardings(cfg, mesh, state_struct, g["batch"])

    @torch.no_grad()
    def serve_step(params, tokens, state):
        with model.bind(gathered_tree(params, p_shard, axes, plan), plan):
            h, new_state = model.decode_step(tokens, _whole(cfg, state, st_shard, plan))
            out = model.greedy(h[:, -1:])
        return out, _blocks(cfg, new_state, st_shard, plan)

    return (
        serve_step,
        (params_struct, tok_struct["tokens"], state_struct),
        (p_shard, tok_shard["tokens"], st_shard),
    )


def _per_key(fn, state, shardings, plan):
    """``fn(key, leaf, sharding, keep)`` for every leaf of ``state``: ``keep``
    is the batch dim, and the heads dim where the rules' block of it is the
    heads the rank computes (:func:`repro_torch.models.state_heads_dim`)."""
    out = {}
    for k, v in state.items():
        leaves, shards = (v, shardings[k]) if isinstance(v, tuple) else ((v,), (shardings[k],))
        got = []
        for x, s in zip(leaves, shards):
            keep = (specs.STATE_BATCH_DIM[k],)
            own = state_heads_dim(k, plan)
            if own is not None and s.tensor_dim("model") == own:
                keep += (own,)
            got.append(fn(k, x, s, keep))
        out[k] = tuple(got) if isinstance(v, tuple) else got[0]
    return out


def _whole(cfg, state, shardings, plan):
    """The decode state as a rank computes with it
    (:func:`repro_torch.models.rank_state`): its rows, whole along every
    other dim but its heads and a conv state's channels, which are the ones
    it computes (cut from the gathered leaf where the rules' block is not)."""
    return _per_key(lambda k, x, s, keep: rank_state(cfg, k, unshard(x, s, keep), plan, keep),
                    state, shardings, plan)


def _blocks(cfg, state, shardings, plan):
    """The inverse: this rank's blocks of the state it computed with, in the
    rules' layout (:func:`repro_torch.models.whole_state`, then cut)."""
    return _per_key(lambda k, x, s, keep: reshard(whole_state(cfg, k, x, plan, keep), s, keep),
                    state, shardings, plan)


def _sharded_specs(shardings, prefix=""):
    """``name -> spec`` of the leaves of a tree of shardings that shard a dim."""
    if isinstance(shardings, dict):
        out = {}
        for k, v in shardings.items():
            out.update(_sharded_specs(v, f"{prefix}{k}."))
        return out
    if isinstance(shardings, tuple):
        return _sharded_specs(dict(enumerate(shardings)), prefix)
    if any(e is not None for e in shardings.spec):
        return {prefix[:-1]: [list(e) if isinstance(e, tuple) else e for e in shardings.spec]}
    return {}


def _localize(tree, shardings, requires_grad=False):
    """Rank 0's blocks of an abstract tree, as ``meta`` tensors."""
    if isinstance(tree, dict):
        return {k: _localize(v, shardings[k], requires_grad) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_localize(v, s, requires_grad) for v, s in zip(tree, shardings))
    t = torch.empty(shardings.local_shape(tree.shape), dtype=tree.dtype, device="meta")
    return t.requires_grad_(True) if requires_grad and tree.is_floating_point() else t


def _storage_bytes(leaves, exclude=()) -> int:
    seen = {t.untyped_storage()._cdata for t in exclude}
    total = 0
    for t in leaves:
        key = t.untyped_storage()._cdata
        if key not in seen:
            seen.add(key)
            total += _nbytes(t)
    return total


# ---------------------------------------------------------------------------
# The dry run
# ---------------------------------------------------------------------------


def run_cell(
    arch: str,
    cell: ShapeCell,
    mesh,
    mesh_name: str,
    *,
    remat: str = "full",
    fsdp: bool = True,
    attn_impl: str = "chunked",
    microbatches: int = 1,
    mode: str = "rolled",
) -> Dict[str, Any]:
    """One cell's record (the reference's ``keep_text`` is gone: eager
    PyTorch has no program text to keep)."""
    record: Dict[str, Any] = {
        "arch": arch,
        "shape": cell.name,
        "mesh": mesh_name,
        "kind": cell.kind,
        "seq_len": cell.seq_len,
        "global_batch": cell.global_batch,
        "remat": remat,
        "fsdp": fsdp,
        "microbatches": microbatches,
        "mode": mode,
    }
    if cell.skipped:
        record["status"] = "skipped"
        record["skip_reason"] = cell.skip_reason
        return record
    cfg = get_config(arch)
    problems = check_divisibility(cfg, mesh, cell.global_batch)
    try:
        step_fn, args, in_shardings = build_cell(
            arch, cell, mesh,
            remat=remat, fsdp=fsdp, attn_impl=attn_impl, microbatches=microbatches,
        )
        local = [_localize(a, s, requires_grad=(cell.kind == "train" and i == 0))
                 for i, (a, s) in enumerate(zip(args, in_shardings))]
        in_leaves = [t for t in tree_leaves(local) if isinstance(t, torch.Tensor)]
        record["placements"] = {"params": _sharded_specs(in_shardings[0])}
        if cell.kind == "decode":
            record["placements"]["state"] = _sharded_specs(in_shardings[2])
        t0 = time.time()
        # the port's layers are a Python loop: "rolled" and "unrolled" count
        # the same (see unrolled_scans)
        ctx = unrolled_scans() if mode == "unrolled" else contextlib.nullcontext()
        with ctx, FlopCounterMode(display=False) as flops, StepTrace(in_leaves) as trace:
            out = step_fn(*local)
            out_leaves = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
            arg_keys = {t.untyped_storage()._cdata for t in in_leaves}
            aliased = [t for t in out_leaves if t.untyped_storage()._cdata in arg_keys]
            fresh = [t for t in out_leaves if t.untyped_storage()._cdata not in arg_keys]
            memory = {
                "argument_bytes": _storage_bytes(in_leaves),
                "output_bytes": sum(_nbytes(t) for t in fresh),
                "temp_bytes": max(0, trace.peak - sum(_nbytes(t) for t in fresh)),
                "alias_bytes": _storage_bytes(aliased),
            }
            del out, out_leaves, aliased, fresh
        t_trace = time.time() - t0
        record.update(
            status="ok",
            lower_s=round(t_trace, 1),
            compile_s=0.0,
            flops=float(flops.get_total_flops()),
            bytes_accessed=float(trace.bytes),
            memory=memory,
            collectives=trace.collectives(),
            divisibility=problems,
        )
    except Exception as e:  # noqa: BLE001 - report, don't crash the sweep
        record["status"] = "error"
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-2000:]
    return record


def _cells(arch: str, shapes, seq_len, global_batch):
    for cell in shape_cells(arch):
        if shapes and cell.name not in shapes:
            continue
        if seq_len or global_batch:
            seq, batch = seq_len or cell.seq_len, global_batch or cell.global_batch
            cell = dataclasses.replace(cell, name=f"{cell.kind}_{seq}x{batch}", seq_len=seq,
                                       global_batch=batch)
        yield cell


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="arch id, or a comma list (default: all)")
    ap.add_argument("--all", action="store_true", help="every arch (the default)")
    ap.add_argument("--shape", default=None, help="shape cell, or a comma list (default: all)")
    ap.add_argument("--seq-len", type=int, default=None,
                    help="replace the cells' sequence length (the cell is renamed kind_SxB)")
    ap.add_argument("--global-batch", type=int, default=None,
                    help="replace the cells' global batch")
    ap.add_argument("--mesh", default="single", choices=sorted(MESH_NAMES))
    ap.add_argument("--remat", default="full", help="none | dots | full, or a comma list")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--microbatches", default="1", help="an integer, or a comma list")
    ap.add_argument("--attn", default="chunked", choices=["chunked", "xla"])
    ap.add_argument("--mode", default="rolled", choices=["rolled", "unrolled"])
    ap.add_argument("--out", default="dryrun_results.json")
    args = ap.parse_args(argv)

    archs = args.arch.split(",") if args.arch else ARCH_IDS
    shapes = args.shape.split(",") if args.shape else None
    remats = args.remat.split(",")
    unknown = [r for r in remats if r not in ("none", "dots", "full")]
    if unknown:
        ap.error(f"unknown remat {unknown}")
    mbs = [int(m) for m in args.microbatches.split(",")]

    results = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    done = {
        (r["arch"], r["shape"], r["mesh"], r.get("remat"), r.get("microbatches"), r.get("mode"))
        for r in results
    }

    for mesh_name in MESH_NAMES[args.mesh]:
        mesh = make_dryrun_mesh(mesh_name)
        for arch in archs:
            for cell in _cells(arch, shapes, args.seq_len, args.global_batch):
                for remat in remats:
                    for mb in mbs:
                        key = (arch, cell.name, mesh_name, remat, mb, args.mode)
                        if key in done:
                            continue
                        print(f"[dryrun] {arch} x {cell.name} on {mesh_name} (remat {remat}, "
                              f"mb {mb}, {args.mode}) ...", flush=True)
                        rec = run_cell(
                            arch, cell, mesh, mesh_name,
                            remat=remat, fsdp=not args.no_fsdp,
                            attn_impl=args.attn, microbatches=mb, mode=args.mode,
                        )
                        status = rec["status"]
                        extra = (
                            f"flops={rec.get('flops', 0):.3e} "
                            f"temp={rec.get('memory', {}).get('temp_bytes', 0)/2**30:.2f}GiB "
                            f"coll={rec.get('collectives', {}).get('total_bytes', 0)/2**30:.3f}GiB"
                            if status == "ok"
                            else rec.get("skip_reason") or rec.get("error", "")[:200]
                        )
                        print(f"[dryrun]   -> {status}: {extra}", flush=True)
                        results.append(rec)
                        with open(args.out, "w") as f:
                            json.dump(results, f, indent=1)
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    n_err = sum(r["status"] == "error" for r in results)
    print(f"[dryrun] done: {n_ok} ok, {n_skip} skipped, {n_err} errors -> {args.out}")


if __name__ == "__main__":
    main()
