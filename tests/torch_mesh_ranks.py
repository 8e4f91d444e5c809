"""Rank functions of the meshed trainer's multi-rank tests.

Each runs as one rank of a ``gloo`` group on the CPU, started by
``tests/test_torch_launch.py`` with ``torch.multiprocessing`` (spawn) and
meeting through a file store, so no network is needed.  This module imports
torch and the port only, never JAX: the ranks load no JAX.  Every rank
gathers what it computed to full tensors (a collective) and rank 0 writes
them to ``out_dir`` for the test to compare.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import json
import os

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

import repro_torch.configs as tconfigs
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.launch.mesh import start_process_group
from repro_torch.models import Model, mamba2, param_axes, param_shapes, split_products, transformer
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import TrainConfig, Trainer
from repro_torch.runtime.trainer import loss_and_grads
from repro_torch.sharding import (
    ModelAxis, Sharding, default_rules, distribute, gathered_tree, logical_to_sharding, model_axis,
    unshard,
)

torch.set_num_threads(1)

ARCH = "stablelm_3b"
STEPS = 3
OPT = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=STEPS)


def config():
    return dataclasses.replace(tconfigs.reduced_config(ARCH), dtype=torch.float32)


def data_config():
    return DataConfig(vocab=config().vocab, seq_len=16, global_batch=8, seed=3)


def trainer(mesh, ckpt_dir, fsdp=True, microbatches=1, checkpoint_every=0):
    tcfg = TrainConfig(steps=STEPS, microbatches=microbatches, checkpoint_every=checkpoint_every,
                       checkpoint_dir=ckpt_dir, fsdp=fsdp, attn_impl="chunked")
    return Trainer(config(), OPT, tcfg, data_config(), device="cpu", mesh=mesh)


def _full(tree):
    return {k: (v.full_tensor() if isinstance(v, DTensor) else v).detach().numpy()
            for k, v in tree.items()}


def _save(out_dir, name, rank, **arrays):
    if rank == 0:
        np.savez(os.path.join(out_dir, f"{name}.npz"), **arrays)


def first_grads(tr, batch):
    """The gradient of every leaf (whole) on ``batch`` (global rows) from
    the trainer's initial parameters (without a mesh, drawn again into the
    model's own)."""
    params, _ = tr.init_state()
    _, grads = loss_and_grads(tr.model, params, tr._put_batch(batch), tr.mesh, tr._shardings)
    if tr.mesh is not None:
        grads = {k: DTensor.from_local(g, tr.mesh, tr._shardings[k].placements, run_check=False)
                 for k, g in grads.items()}
    return _full(grads)


def _run(mesh, out_dir, name, rank, grads=True, **kw):
    tr = trainer(mesh, os.path.join(out_dir, f"ck_{name}"), **kw)
    if grads:
        _save(out_dir, f"{name}_grads", rank, **first_grads(tr, SyntheticLM(data_config()).batch(0)))
    out = tr.run()
    _save(out_dir, name, rank, losses=np.array(out["losses"]),
          **{f"p.{k}": v for k, v in _full(out["params"]).items()},
          **{f"mu.{k}": v for k, v in _full(out["opt_state"]["mu"]).items()},
          **{f"nu.{k}": v for k, v in _full(out["opt_state"]["nu"]).items()})
    return out


def two_ranks(rank: int, init_file: str, out_dir: str) -> None:
    """data=2 with fsdp: 3 steps (saved at step 3), the same with 2
    microbatches, then the step-3 checkpoint restored under a ``(1, 2)``
    mesh without fsdp."""
    start_process_group("cpu", rank, 2, init_file)
    try:
        mesh = init_device_mesh("cpu", (2, 1), mesh_dim_names=("data", "model"))
        _run(mesh, out_dir, "data2", rank, checkpoint_every=STEPS)
        _run(mesh, out_dir, "data2_mb2", rank, grads=False, microbatches=2)
        tr = trainer(mesh, os.path.join(out_dir, "ck_data2"), fsdp=False)
        tr.remesh(init_device_mesh("cpu", (1, 2), mesh_dim_names=("data", "model")))
        params, opt = tr.init_state()
        opt, step = tr._restore(params, opt)
        local_shapes = {k: list(p.to_local().shape) for k, p in params.items()}
        _save(out_dir, "restored_1x2", rank, step=np.array(step),
              local_shapes=np.array(json.dumps(local_shapes)),
              **{f"p.{k}": v for k, v in _full(params).items()},
              **{f"mu.{k}": v for k, v in _full(opt["mu"]).items()},
              **{f"nu.{k}": v for k, v in _full(opt["nu"]).items()})
    finally:
        dist.destroy_process_group()


def four_ranks(rank: int, init_file: str, out_dir: str) -> None:
    """fsdp on ``(data=2, model=2)`` and on ``(pod=2, data=2, model=1)``
    (the embed axis over two mesh axes), 3 steps each; and the batch rows
    that ``("pod", "data")`` gives each rank, gathered back and their
    gradient summed over both axes."""
    start_process_group("cpu", rank, 4, init_file)
    try:
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        _run(mesh, out_dir, "data2_model2", rank)
        pods = init_device_mesh("cpu", (2, 2, 1), mesh_dim_names=("pod", "data", "model"))
        _run(pods, out_dir, "pod2_data2", rank)

        full = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)
        s = Sharding(pods, (("pod", "data"), None))
        block = distribute(full, s)
        local = block.to_local().clone().requires_grad_(True)
        whole = unshard(local, s)
        (whole * whole).sum().backward()
        coord = pods.get_coordinate()
        _save(out_dir, "batch_rows", rank, coord=np.array(coord),
              local=local.detach().numpy(), gathered=whole.detach().numpy(),
              grad=local.grad.numpy(), full_tensor=block.full_tensor().numpy())
        rows = [None] * 4
        dist.all_gather_object(rows, [rank, list(coord), local.detach().numpy().tolist()])
        _save(out_dir, "batch_rows_all", rank, rows=np.array(json.dumps(rows)))
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Tensor- and expert-parallel products on the model axis
# ---------------------------------------------------------------------------

#: the reduced configs of the tensor-parallel runs, float32: name -> (arch,
#: what replaces the reduced config's fields; a function, so that it applies
#: to the reference's config too)
TP_CONFIGS = {
    "stablelm": ("stablelm_3b", lambda c: c),                     # 4 / 4 heads
    "qwen2_7b": ("qwen2_7b", lambda c: dataclasses.replace(c, head_dim=16)),   # 4 / 2
    "qwen2_vl": ("qwen2_vl_2b", lambda c: c),                     # vision prefix, M-RoPE
    "qwen2_moe": ("qwen2_moe_a2_7b", lambda c: c),                # 8 experts, shared
    "qwen2_moe_e6": ("qwen2_moe_a2_7b",                           # 6: ff_expert on 4 ranks
                     lambda c: dataclasses.replace(c, moe=dataclasses.replace(c.moe,
                                                                                n_experts=6))),
    "llama4": ("llama4_scout_17b_a16e", lambda c: c),             # 4 experts, chunked attention
    "vocab250": ("stablelm_3b", lambda c: dataclasses.replace(c, vocab=250)),
    "mamba2": ("mamba2_370m", lambda c: c),                       # 4 SSM heads
    "zamba2": ("zamba2_2_7b", lambda c: c),                       # 4 SSM heads, 4 / 4 shared
    "whisper": ("whisper_large_v3", lambda c: c),                 # 4 / 4 heads
    "whisper_h6": ("whisper_large_v3",                            # 6 heads: whole on 4 ranks
                   lambda c: dataclasses.replace(c, n_heads=6, n_kv_heads=6, head_dim=16)),
}
#: the meshes ``(data, model)`` of the 2- and 4-rank runs
TP_MESHES = {2: [(1, 2)], 4: [(1, 4), (2, 2)]}
TP_DATA = dict(seq_len=40, global_batch=4, seed=5)
#: serving: 2 prompts of 136 tokens (272 > 256: the MoE capacity path), 4
#: greedy steps; the vlm's prompts open with 8 patch embeddings
TP_SERVE = dict(batch=2, prompt=136, steps=4, patches=8, seed=6)
#: the audio family's frames (training and serving) and the token its
#: decoding starts from
TP_FRAMES = 12
TP_START = 1
TP_IMPLS = ("xla", "chunked")


def tp_config(name):
    arch, change = TP_CONFIGS[name]
    return dataclasses.replace(change(tconfigs.reduced_config(arch)), dtype=torch.float32)


def tp_data(cfg):
    return DataConfig(vocab=cfg.vocab, **TP_DATA)


def vision_inputs(cfg, B, S, P, seed):
    """A vlm's ``patch_embeds`` and ``mrope_positions`` (patch ``i`` of a 4 x 2
    grid at ``(0, i // 2, i % 2)``, text token ``j`` after it at ``4 + j``);
    nothing for the other families."""
    if cfg.family != "vlm":
        return {}
    pos = np.zeros((B, S, 3), np.int32)
    i = np.arange(P)
    pos[:, :P] = np.stack([np.zeros_like(i), i // 2, i % 2], -1)
    pos[:, P:] = (4 + np.arange(S - P))[:, None]
    patches = np.random.default_rng(seed).standard_normal((B, P, cfg.d_model)) * 0.5
    return {"patch_embeds": patches.astype(np.float32), "mrope_positions": pos}


def frame_inputs(cfg, B, seed):
    """The audio family's ``frame_embeds`` (:data:`TP_FRAMES` of them a
    row); nothing for the other families."""
    if cfg.family != "audio":
        return {}
    frames = np.random.default_rng(seed).standard_normal((B, TP_FRAMES, cfg.d_model)) * 0.5
    return {"frame_embeds": frames.astype(np.float32)}


def model_inputs(cfg, B, S, P, seed):
    """The inputs beside the tokens a family takes: the vlm's vision inputs,
    the audio family's frames."""
    return {**vision_inputs(cfg, B, S, P, seed), **frame_inputs(cfg, B, seed)}


def tp_batch(cfg, i):
    """Step ``i``'s global batch, with the vlm's vision inputs and the audio
    family's frames."""
    return {**SyntheticLM(tp_data(cfg)).batch(i),
            **model_inputs(cfg, TP_DATA["global_batch"], TP_DATA["seq_len"], 8, i)}


def tp_train(cfg, mesh, ckpt_dir):
    """The trainer on ``mesh`` (or none; fsdp on a mesh): the first batch's
    gradients of every leaf (whole), then 3 steps.  Returns the gradients,
    the losses, the global gradient norms and the parameters."""
    tcfg = TrainConfig(steps=STEPS, checkpoint_every=0, checkpoint_dir=ckpt_dir,
                       fsdp=mesh is not None, attn_impl="chunked")
    tr = Trainer(cfg, OPT, tcfg, tp_data(cfg), device="cpu", mesh=mesh)
    grads = first_grads(tr, tp_batch(cfg, 0))
    params, opt = tr.init_state()
    losses, norms = [], []
    for i in range(STEPS):
        opt, metrics = tr.step(params, opt, tr._put_batch(tp_batch(cfg, i)))
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    return grads, np.array(losses), np.array(norms), params


def tie_heads(cfg, params):
    """Every block of the head's vocabulary dim the same as the first (of 4),
    so that the largest logit is tied across the ranks' blocks."""
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    n = cfg.vocab // 4
    with torch.no_grad():
        for j in range(1, 4):
            w[:, j * n:(j + 1) * n] = w[:, :n]


def serving_params(cfg, tie=False):
    params = {k: p.detach() for k, p in Model(cfg, device="cpu").init(seed=0).named_parameters()}
    if tie:
        tie_heads(cfg, params)
    return params


@contextlib.contextmanager
def states_in(dtype):
    """``Model.prefill``'s transformer KV caches and mamba conv states in
    ``dtype`` (bfloat16 by default, as the reference keeps them) while the
    context lasts."""
    make_kv, make_states = transformer.init_kv_cache, mamba2.init_states

    def init_states(*args, **kwargs):
        ssm, conv = make_states(*args, **kwargs)
        return ssm, conv.to(dtype)

    transformer.init_kv_cache = functools.partial(make_kv, dtype=dtype)
    mamba2.init_states = init_states
    try:
        yield
    finally:
        transformer.init_kv_cache, mamba2.init_states = make_kv, make_states


def tp_serve(cfg, impl, mesh=None, tie=False, cache=torch.float32):
    """Prefill then greedy decode steps on ``mesh`` (the rules' layout, no
    fsdp) or without one, the KV caches and conv states in ``cache``: the
    whole logits of each step and the greedy tokens (``Model.greedy``).
    The audio family decodes from its encoder output and a start token."""
    params = serving_params(cfg, tie)
    s = TP_SERVE
    rng = np.random.default_rng(s["seed"])
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (s["batch"], s["prompt"])))}
    batch.update({k: torch.from_numpy(v) for k, v in model_inputs(
        cfg, s["batch"], s["prompt"], s["patches"], s["seed"]).items()})
    if mesh is None:
        model = Model(cfg, attn_impl=impl, device="cpu")
        model.load_state_dict(params)
        ctx = contextlib.nullcontext()
    else:
        shardings = tp_shardings(cfg, mesh, fsdp=False)
        blocks = {k: distribute(p, shardings[k]).to_local() for k, p in params.items()}
        model = Model(cfg, attn_impl=impl, device="cpu", storage="meta")
        ctx = bound(model, blocks, shardings)
    logits, tokens = [], []
    with ctx, torch.no_grad(), states_in(cache):
        h, state = model.prefill(batch, max_len=s["prompt"] + s["steps"]
                                 + (cfg.family == "audio"))
        if cfg.family == "audio":
            h, state = model.decode_step(torch.full((s["batch"], 1), TP_START), state)
        for step in range(s["steps"] + 1):
            logits.append(model.logits(h[:, -1]))
            tokens.append(model.greedy(h[:, -1]))
            if step < s["steps"]:
                h, state = model.decode_step(tokens[-1][:, None], state)
    return torch.stack(logits).numpy(), torch.stack(tokens).numpy()


def bound(model, blocks, shardings):
    """``model`` bound to this rank's ``blocks`` under its plan, as the
    trainer binds it."""
    plan = model_axis(split_products(model.cfg), shardings)
    return model.bind(gathered_tree(blocks, shardings, param_axes(model.cfg), plan), plan)


def tp_shardings(cfg, mesh, fsdp):
    rules = default_rules(mesh, n_experts=cfg.moe.n_experts if cfg.moe else 0, fsdp=fsdp)
    like = {k: torch.empty(v, device="meta") for k, v in param_shapes(cfg).items()}
    return logical_to_sharding(param_axes(cfg), mesh, rules, like=like)


class LeafFlops(TorchDispatchMode):
    """Matrix-product flops by the parameter leaf one of whose operands is
    (a view of) its storage, or a copy made of it alone (gathered over a
    mesh axis, cut into pieces and put together), and the functional
    collectives by op and process group, with their operands' shapes."""

    PRODUCTS = {torch.ops.aten.mm: (0, 1), torch.ops.aten.bmm: (0, 1),
                torch.ops.aten.addmm: (1, 2), torch.ops.aten.baddbmm: (1, 2)}
    #: the ops whose output is a leaf's where every input is that leaf's
    COPIES = ("clone", "cat", "_to_copy", "all_gather_into_tensor", "wait_tensor")

    def __init__(self, leaves):
        super().__init__()
        self.names = {t.untyped_storage().data_ptr(): k for k, t in leaves.items()}
        self.copies = []     # kept alive, so that no other tensor takes their address
        self.flops = collections.Counter()
        self.collectives = []

    def _name(self, t):
        return self.names.get(t.untyped_storage().data_ptr())

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        operands = self.PRODUCTS.get(func.overloadpacket)
        if operands is not None:
            a, b = (args[i] for i in operands)
            n = 2 * out.numel() * a.shape[-1]
            self.flops["total"] += n
            for name in {self._name(t) for t in (a, b)} - {None}:
                self.flops[name] += n
            return out
        if func.namespace == "_c10d_functional" and func._opname != "wait_tensor":
            self.collectives.append((func._opname, args[-1], list(args[0].shape)))
        if func._opname in self.COPIES and isinstance(out, torch.Tensor):
            names = {self._name(t) for t in tree_leaves(args) if isinstance(t, torch.Tensor)}
            if len(names) == 1 and None not in names:
                self.names[out.untyped_storage().data_ptr()] = names.pop()
                self.copies.append(out)
        return out


def tp_flops(cfg, mesh=None):
    """One forward of ``train_loss`` on the first training batch (this
    rank's rows), counted by :class:`LeafFlops` and by ``FlopCounterMode``:
    ``(flops by leaf with "total" and "counter", collectives)``."""
    from torch.utils.flop_counter import FlopCounterMode

    params = serving_params(cfg)
    batch = {k: torch.from_numpy(v) for k, v in tp_batch(cfg, 0).items()}
    if mesh is None:
        model = Model(cfg, attn_impl="chunked", device="cpu")
        model.load_state_dict(params)
        leaves, ctx = dict(model.named_parameters()), contextlib.nullcontext()
    else:
        shardings = tp_shardings(cfg, mesh, fsdp=True)
        leaves = {k: distribute(p, shardings[k]).to_local() for k, p in params.items()}
        model = Model(cfg, attn_impl="chunked", device="cpu", storage="meta")
        ctx = bound(model, leaves, shardings)
    with torch.no_grad(), ctx, FlopCounterMode(display=False) as counter, LeafFlops(leaves) as mode:
        model.train_loss(batch)
    return {**mode.flops, "counter": counter.get_total_flops()}, mode.collectives


def all_sum_check(mesh):
    """Each rank's part ``[1 + r, 2 + r]`` summed over ``model`` by
    ``ModelAxis.all_sum``, then rank ``r``'s sum weighed by ``r + 1``:
    every rank's parts, sums and its part's gradient."""
    r, M = mesh.get_coordinate()[1], mesh.shape[1]
    plan = ModelAxis(mesh.get_group("model"), {"p": (r, r + 1)})
    part = torch.tensor([1.0 + r, 2.0 + r], requires_grad=True)
    total = plan.all_sum(part, "p")
    (total * (r + 1)).sum().backward()
    every = [None] * M
    dist.all_gather_object(every, [part.tolist(), total.tolist(), part.grad.tolist()],
                           group=mesh.get_group("model"))
    return {k: np.array([e[i] for e in every]) for i, k in enumerate(("parts", "sum", "grad"))}


def _tp_ranks(rank, init_file, out_dir, world):
    start_process_group("cpu", rank, world, init_file)
    try:
        for data, model in TP_MESHES[world]:
            mesh = init_device_mesh("cpu", (data, model), mesh_dim_names=("data", "model"))
            tag = f"data{data}_model{model}"
            for name in TP_CONFIGS:
                cfg = tp_config(name)
                grads, losses, norms, params = tp_train(cfg, mesh, os.path.join(out_dir, "ck"))
                _save(out_dir, f"train_{tag}_{name}", rank, losses=losses, norms=norms,
                      **{f"g.{k}": v for k, v in grads.items()},
                      **{f"p.{k}": v for k, v in _full(params).items()})
                if data > 1:
                    continue
                for impl in TP_IMPLS:
                    logits, tokens = tp_serve(cfg, impl, mesh)
                    _save(out_dir, f"serve_{tag}_{name}_{impl}", rank, logits=logits,
                          tokens=tokens)
                logits, tokens = tp_serve(cfg, "chunked", mesh, cache=torch.bfloat16)
                _save(out_dir, f"serve_{tag}_{name}_bf16", rank, logits=logits, tokens=tokens)
                flops, colls = tp_flops(cfg, mesh)
                every = [None] * world
                dist.all_gather_object(every, {"flops": dict(flops), "collectives": colls,
                                               "model_group": mesh.get_group("model").group_name})
                _save(out_dir, f"flops_{tag}_{name}", rank, ranks=np.array(json.dumps(every)))
            if data == 1:
                logits, tokens = tp_serve(tp_config("stablelm"), "chunked", mesh, tie=True)
                _save(out_dir, f"serve_{tag}_tie", rank, logits=logits, tokens=tokens)
                _save(out_dir, f"all_sum_{tag}", rank, **all_sum_check(mesh))
    finally:
        dist.destroy_process_group()


def tp_two_ranks(rank: int, init_file: str, out_dir: str) -> None:
    """``(data=1, model=2)``: every tensor-parallel config trained 3 steps,
    served and counted, the tied head served and ``ModelAxis.all_sum``
    checked."""
    _tp_ranks(rank, init_file, out_dir, 2)


def tp_four_ranks(rank: int, init_file: str, out_dir: str) -> None:
    """``(data=1, model=4)`` as ``tp_two_ranks``, then ``(data=2, model=2)``
    with fsdp, trained 3 steps."""
    _tp_ranks(rank, init_file, out_dir, 4)
