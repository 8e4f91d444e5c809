"""The port's launch tools against the reference's, on the CPU.

* ``configs.shape_cells`` and ``launch.specs`` (shapes and dtypes of every
  cell's abstract inputs) against the reference's;
* the dry-run: a reduced cell's record carries the reference's keys, its
  ``flops`` are the products counted by hand from the shapes, per device on a
  mesh, and a known all-gather gives the expected collective bytes; a cell
  that fails is recorded as ``error``;
* the meshed trainer on 2 and 4 ``gloo`` ranks (``tests/torch_mesh_ranks.py``,
  which imports no JAX): fsdp in float32 against the port's 1-rank run
  (within 1e-5) and the reference's un-meshed step (the losses, within 1e-5),
  2 microbatches against 1, a checkpoint saved under ``data=2`` restored under
  ``(1, 2)`` and without a mesh bit for bit; and the train CLI on 2 ranks.

Every multi-rank run has its own deadline, after which its ranks are killed:
a rank that dies leaves the others waiting in a collective.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
import torch_mesh_ranks as ranks
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLM as JSyntheticLM
from repro.launch import specs as jspecs
from repro.models import Model as JModel
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jadamw_init
from repro.optim import adamw_update as jadamw_update
from repro_torch import convert
from repro_torch.checkpoint import restore_tree
from repro_torch.configs import ShapeCell
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import DRYRUN_MESHES, fake_mesh
from repro_torch.models import Model
from repro_torch.runtime import TrainConfig, Trainer

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = tconfigs.ARCH_IDS
#: the record keys of the reference's dry-run (``repro/launch/dryrun.py``)
RECORD_KEYS = {"arch", "shape", "mesh", "kind", "seq_len", "global_batch", "remat", "fsdp",
               "microbatches", "mode", "status", "lower_s", "compile_s", "flops",
               "bytes_accessed", "memory", "collectives", "divisibility"}
MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes"}
COLLECTIVE_KEYS = {"bytes_by_type", "counts", "total_bytes", "wire_bytes"}


# ---------------------------------------------------------------------------
# Configs and specs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_shape_cells_match_reference(arch):
    assert tconfigs.shape_cells(arch) == [
        ShapeCell(c.name, c.seq_len, c.global_batch, c.kind, c.skip_reason)
        for c in jconfigs.shape_cells(arch)]


def test_shape_cells_cover_assignment():
    """The reference's ``test_models.py::test_shape_cells_cover_assignment``
    on the port's cells."""
    total = skipped = 0
    for arch in ARCHS:
        cells = tconfigs.shape_cells(arch)
        assert [c.name for c in cells] == ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
        total += len(cells)
        skipped += sum(c.skipped for c in cells)
        long = cells[-1]
        if arch in ("gemma3_1b", "llama4_scout_17b_a16e", "mamba2_370m", "zamba2_2_7b"):
            assert not long.skipped, arch
        else:
            assert long.skipped, arch
    assert total == 40
    assert skipped == 6


def _same_structs(got, want):
    if isinstance(got, dict):
        assert sorted(got) == sorted(want)
        for k in got:
            _same_structs(got[k], want[k])
    elif isinstance(got, tuple):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _same_structs(a, b)
    else:
        assert got.device.type == "meta"
        assert tuple(got.shape) == tuple(want.shape)
        assert str(got.dtype).replace("torch.", "") == str(want.dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_reference(arch):
    """Every cell's abstract inputs and decode state: shapes and dtypes."""
    cfg, jcfg = tconfigs.get_config(arch), jconfigs.get_config(arch)
    for cell, jcell in zip(tconfigs.shape_cells(arch), jconfigs.shape_cells(arch)):
        assert specs.cell_geometry(cfg, cell) == jspecs.cell_geometry(jcfg, jcell)
        _same_structs(specs.train_inputs(cfg, cell), jspecs.train_inputs(jcfg, jcell))
        _same_structs(specs.prefill_inputs(cfg, cell), jspecs.prefill_inputs(jcfg, jcell))
        _same_structs(specs.decode_inputs(cfg, cell), jspecs.decode_inputs(jcfg, jcell))


# ---------------------------------------------------------------------------
# The dry-run
# ---------------------------------------------------------------------------


@pytest.fixture
def reduced_dryrun(monkeypatch):
    """The dry-run on the reduced configs, and ``mesh(name)``: a fake mesh,
    whose group is ended after the test."""
    monkeypatch.setattr(dryrun, "get_config", tconfigs.reduced_config)
    yield lambda name: fake_mesh(*DRYRUN_MESHES[name])
    if dist.is_initialized():
        dist.destroy_process_group()


def _attention_flops(cfg, B, S, K):
    """Products of one layer's attention over ``S`` queries and ``K`` keys."""
    D, Hq, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.dh
    proj = 2 * B * S * D * (Hq * Dh + 2 * Hkv * Dh) + 2 * B * S * Hq * Dh * D
    return proj + 2 * (2 * B * Hq * S * K * Dh)


def _mlp_flops(cfg, B, S):
    """Products of one dense layer's MLP."""
    return 3 * 2 * B * S * cfg.d_model * cfg.d_ff


def _layer_flops(cfg, B, S, K):
    """Products of one dense layer over ``S`` queries and ``K`` keys."""
    return _attention_flops(cfg, B, S, K) + _mlp_flops(cfg, B, S)


def test_dryrun_record_has_the_reference_keys_and_counted_flops(reduced_dryrun):
    """A reduced stablelm cell on the card's one-rank mesh: the reference's
    keys, no collective (one rank), and the products counted by hand: a
    prefill is every layer once (keys padded to the chunked path's 1,024)
    and the head at the last position; a training step without remat is
    three times the layers (forward, then the gradients of both operands)
    and four times the head (its chunk is recomputed in backward)."""
    cfg = tconfigs.reduced_config("stablelm_3b")
    mesh = reduced_dryrun("1gpu")
    B, S = 4, 32
    pre = dryrun.run_cell("stablelm_3b", ShapeCell("prefill_s", S, B, "prefill"), mesh, "1gpu")
    assert pre["status"] == "ok", pre.get("error")
    assert set(pre) == RECORD_KEYS | {"placements"}
    assert set(pre["memory"]) == MEMORY_KEYS and set(pre["collectives"]) == COLLECTIVE_KEYS
    assert pre["collectives"]["total_bytes"] == pre["collectives"]["wire_bytes"] == 0
    assert pre["flops"] == cfg.n_layers * _layer_flops(cfg, B, S, 1024) + 2 * B * cfg.d_model * cfg.vocab
    train = dryrun.run_cell("stablelm_3b", ShapeCell("train_s", S, B, "train"), mesh, "1gpu",
                            remat="none")
    assert train["status"] == "ok", train.get("error")
    head = 2 * B * S * cfg.d_model * cfg.vocab
    assert train["flops"] == 3 * cfg.n_layers * _layer_flops(cfg, B, S, 1024) + 4 * head
    mem = train["memory"]
    leaves = Model(cfg, device="meta").abstract_init()[0].values()
    params = sum(p.numel() * p.element_size() for p in leaves)
    state = params + 2 * 4 * sum(p.numel() for p in leaves) + 4   # two float32 moments, count
    assert mem["argument_bytes"] == state + 2 * B * S * 4            # the two int32 rows
    # updated in place: the parameters and moments (the new count is a new tensor)
    assert mem["alias_bytes"] == state - 4 and mem["temp_bytes"] > params
    assert pre["bytes_accessed"] > 0


def test_dryrun_flops_are_per_device(reduced_dryrun):
    """On 16x16 a rank computes a sixteenth of the batch (the data axis) and,
    on the model axis, a sixteenth of each product the rules split there:
    the MLP (``d_ff`` 128) and the head (vocabulary 256); reduced stablelm's
    4 heads do not divide 16, so its attention is whole.  Without remat a
    layer's products count 3 times and the head's 4, as on one rank.  The
    all-gathers over ``model`` are the attention weights' alone (wq, wk, wv,
    wo a layer): none of the MLP's, the head's or the embedding's."""
    cfg = tconfigs.reduced_config("stablelm_3b")
    cell = ShapeCell("train_s", 32, 32, "train")
    one = dryrun.run_cell("stablelm_3b", cell, reduced_dryrun("1gpu"), "1gpu", remat="none")
    many = dryrun.run_cell("stablelm_3b", cell, reduced_dryrun("16x16"), "16x16", remat="none")
    assert one["status"] == many["status"] == "ok", (one.get("error"), many.get("error"))
    L, D, V = cfg.n_layers, cfg.d_model, cfg.vocab
    B = 32 // 16
    want = (3 * L * (_attention_flops(cfg, B, 32, 1024) + _mlp_flops(cfg, B, 32) / 16)
            + 4 * 2 * B * 32 * D * V / 16)
    assert many["flops"] == pytest.approx(want, rel=1e-9)
    counts = many["collectives"]["counts"]
    assert counts["all-gather"] > 0 and counts["reduce-scatter"] > 0 and counts["all-reduce"] > 0
    assert many["memory"]["argument_bytes"] < one["memory"]["argument_bytes"]

    mesh = reduced_dryrun("16x16")
    step, args, shardings = dryrun.build_cell("stablelm_3b", cell, mesh, remat="none")
    local = [dryrun._localize(a, s, requires_grad=i == 0)
             for i, (a, s) in enumerate(zip(args, shardings))]
    with ranks.LeafFlops({}) as rec:
        step(*local)
    model = mesh.get_group("model").group_name
    gathers = [shape for op, group, shape in rec.collectives
               if op == "all_gather_into_tensor" and group == model]
    # each attention weight's block: its D rows over data, its heads over model
    assert gathers == [[cfg.n_heads * cfg.dh // 16, D // 16]] * (4 * L)


def test_prefill_state_need_not_divide_the_model_axis(reduced_dryrun):
    """whisper's prefill cache is as long as its budget (500 positions here,
    31,268 at prefill_32k), which 16 does not divide; its few KV heads do not
    either.  The prefill's state stays as computed, as the reference leaves
    its prefill's output unsharded, so the cell runs."""
    rec = dryrun.run_cell("whisper_large_v3", ShapeCell("prefill_s", 2000, 16, "prefill"),
                          reduced_dryrun("16x16"), "16x16")
    assert rec["status"] == "ok", rec.get("error")
    assert rec["memory"]["output_bytes"] > 0


def test_known_all_gather_gives_the_ring_bytes(reduced_dryrun):
    """``DTensor.full_tensor()`` of a block sharded 16 ways on the model axis:
    one all-gather whose operand is the block and whose wire bytes are the
    ring's ``(g - 1) / g`` of the result."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = reduced_dryrun("16x16")
    block = torch.empty(4, 8, device="meta")
    t = DTensor.from_local(block, mesh, [Replicate(), Shard(0)], run_check=False)
    with dryrun.StepTrace() as trace:
        full = t.full_tensor()
    assert tuple(full.shape) == (64, 8)
    coll = trace.collectives()
    assert coll["counts"]["all-gather"] == 1 and sum(coll["counts"].values()) == 1
    assert coll["bytes_by_type"]["all-gather"] == coll["total_bytes"] == 4 * 8 * 4
    assert coll["wire_bytes"] == 64 * 8 * 4 * 15 // 16


def test_failing_cell_is_recorded_not_raised(reduced_dryrun, tmp_path):
    """A vlm cell shorter than its 256 patch embeddings cannot run: the record
    says ``error`` with the message; the CLI writes it beside the cells that
    ran and goes on."""
    rec = dryrun.run_cell("qwen2_vl_2b", ShapeCell("prefill_s", 64, 2, "prefill"),
                          reduced_dryrun("1gpu"), "1gpu")
    assert rec["status"] == "error" and rec["error"].startswith("RuntimeError")
    assert "traceback" in rec
    out = tmp_path / "records.json"
    dryrun.main(["--arch", "qwen2_vl_2b,stablelm_3b", "--shape", "prefill_32k", "--mesh", "1gpu",
                 "--seq-len", "64", "--global-batch", "2", "--out", str(out)])
    records = json.loads(out.read_text())
    assert [(r["arch"], r["shape"], r["status"]) for r in records] == [
        ("qwen2_vl_2b", "prefill_64x2", "error"), ("stablelm_3b", "prefill_64x2", "ok")]


# ---------------------------------------------------------------------------
# The meshed trainer on several ranks
# ---------------------------------------------------------------------------


def _spawn(fn, world, tmp_path, deadline_s=240):
    """Run ``fn(rank, init_file, out_dir)`` on ``world`` spawned ranks; kill
    them all if they are not done by the deadline."""
    ctx = torch.multiprocessing.start_processes(
        fn, args=(str(tmp_path / "store"), str(tmp_path)), nprocs=world, join=False,
        start_method="spawn")
    end = time.monotonic() + deadline_s
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > end:
                raise TimeoutError(f"{fn.__name__} on {world} ranks passed {deadline_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(5)
    out = {name[:-4]: dict(np.load(tmp_path / name))
           for name in os.listdir(tmp_path) if name.endswith(".npz")}
    out["dir"] = tmp_path
    return out


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return _spawn(ranks.two_ranks, 2, tmp_path_factory.mktemp("two"))


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return _spawn(ranks.four_ranks, 4, tmp_path_factory.mktemp("four"))


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """The port's trainer without a mesh on the same data."""
    tcfg = TrainConfig(steps=ranks.STEPS, checkpoint_every=0, attn_impl="chunked",
                       checkpoint_dir=str(tmp_path_factory.mktemp("one")))
    tr = Trainer(ranks.config(), ranks.OPT, tcfg, ranks.data_config(), device="cpu")
    grads = ranks.first_grads(tr, ranks.SyntheticLM(ranks.data_config()).batch(0))
    out = tr.run()
    return {"losses": np.array(out["losses"]), "grads": grads,
            **{f"p.{k}": v.numpy() for k, v in out["params"].items()}}


@pytest.fixture(scope="module")
def reference_losses():
    """The reference's un-meshed step (``value_and_grad`` of its
    ``train_loss``, then its ``adamw_update``) from the port's initial
    weights on the same batches."""
    cfg = ranks.config()
    init = Model(cfg, device="cpu").init(seed=0)
    params = jax.tree.map(jnp.asarray, convert.params_to_reference(
        {k: p.detach() for k, p in init.named_parameters()}))
    jcfg = dataclasses.replace(jconfigs.reduced_config(ranks.ARCH), dtype=jnp.float32)
    jmodel = JModel(jcfg, attn_impl="chunked")
    ocfg = JAdamWConfig(**dataclasses.asdict(ranks.OPT))
    data = ranks.data_config()
    pipe = JSyntheticLM(JDataConfig(vocab=data.vocab, seq_len=data.seq_len,
                                    global_batch=data.global_batch, seed=data.seed))
    opt, losses = jadamw_init(params), []
    step = jax.jit(lambda p, o, b: (jax.value_and_grad(jmodel.train_loss)(p, b), p, o))
    for i in range(ranks.STEPS):
        batch = {k: jnp.asarray(v) for k, v in pipe.batch(i).items()}
        (loss, grads), _, _ = step(params, opt, batch)
        params, opt, _ = jadamw_update(ocfg, params, grads, opt)
        losses.append(float(loss))
    return np.array(losses)


def _params(run):
    return {k[2:]: v for k, v in run.items() if k.startswith("p.")}


#: below this an element's first gradient is rounding noise to Adam (100 x
#: its eps): see :func:`rounding_noise`
NOISE = 1e-6


def rounding_noise(grads):
    """Per leaf, the elements whose first gradient (un-meshed) is not 0 but
    below :data:`NOISE`: terms that cancel, so that the float32 rounding of
    the terms (the products split over ``model`` sum their parts in another
    order) is a large share of the sum.  Adam's first step there is
    ``g / (|g| + 1e-8)``, which such a difference moves by a share of the
    rate: at 1e-3 by more than 1e-5 on single elements whose gradients were
    8e-9 to 2.4e-7.  The gradients themselves are held at 1e-5."""
    return {k: (g != 0) & (np.abs(g) < NOISE) for k, g in grads.items()}


def _close(got, want, tol=1e-5, skip=None):
    """Every leaf of ``got`` within ``tol`` of ``want``, but the elements
    ``skip`` marks."""
    assert sorted(got) == sorted(want)
    for k in got:
        a, b = got[k], want[k]
        if skip is not None:
            a, b = a[~skip[k]], b[~skip[k]]
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol, err_msg=k)


@pytest.mark.parametrize("run", ["data2", "data2_model2", "pod2_data2"])
def test_fsdp_on_ranks_matches_one_rank_and_the_reference(run, two, four, one_rank,
                                                          reference_losses):
    """float32, 3 steps: the first batch's gradient of every leaf, the losses
    and every parameter against the port's trainer without a mesh (1e-5), the
    losses against the reference's un-meshed step (1e-5).  ``data2_model2``
    computes its share of the heads, the MLP and the vocabulary on the model
    axis, so its parameters are held but for the elements whose first
    gradient is rounding noise (:func:`rounding_noise`)."""
    ranks_out = {"data2": two, "data2_model2": four, "pod2_data2": four}[run]
    got = ranks_out[run]
    _close(ranks_out[f"{run}_grads"], one_rank["grads"])
    np.testing.assert_allclose(got["losses"], one_rank["losses"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["losses"], reference_losses, rtol=1e-5, atol=1e-5)
    skip = rounding_noise(one_rank["grads"]) if run == "data2_model2" else None
    _close(_params(got), _params(one_rank), skip=skip)


def test_microbatches_match_one_batch_on_ranks(two):
    """``test_runtime.py::test_grad_accumulation_equivalence`` on the meshed
    trainer (data=2, fsdp): 2 microbatches give what 1 gives."""
    np.testing.assert_allclose(two["data2_mb2"]["losses"], two["data2"]["losses"],
                               rtol=1e-5, atol=1e-5)
    _close(_params(two["data2_mb2"]), _params(two["data2"]))


def test_checkpoint_restores_across_meshes_bit_for_bit(two):
    """Saved at step 3 under data=2 with fsdp; restored under (1, 2) without
    fsdp, and without a mesh: every parameter and moment bit for bit."""
    saved, restored = two["data2"], two["restored_1x2"]
    assert int(restored["step"]) == ranks.STEPS
    for key, value in saved.items():
        if key != "losses":
            np.testing.assert_array_equal(restored[key], value, err_msg=key)
    shapes = json.loads(str(restored["local_shapes"]))   # the (1, 2) layout: vocab split on model
    assert shapes["embed"] == [ranks.config().vocab // 2, ranks.config().d_model]
    # without a mesh: the same files into plain tensors
    ck = two["dir"] / "ck_data2"
    path = os.path.join(ck, sorted(os.listdir(ck))[-1])
    like = {"params": _nest({k: torch.zeros(v.shape) for k, v in _params(saved).items()})}
    tree, extra = restore_tree(path, like)
    assert extra["data_index"] == ranks.STEPS
    for k, v in _flat(tree["params"]).items():
        assert not hasattr(v, "placements")
        np.testing.assert_array_equal(v.numpy(), saved[f"p.{k}"], err_msg=k)


def _nest(flat):
    tree = {}
    for name, t in flat.items():
        node = tree
        *parents, leaf = name.split(".")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = t
    return tree


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def test_batch_rows_over_pod_and_data(four):
    """``("pod", "data")`` on one dim: rank (p, d) holds rows ``2 (2p + d)``..,
    the gather puts them back in order, and the gradient of a loss every rank
    computes on the whole is summed over both axes (4 ranks)."""
    rows = json.loads(str(four["batch_rows_all"]["rows"]))
    full = np.arange(24, dtype=np.float32).reshape(8, 3)
    for rank, (p, d, _), local in rows:
        idx = 2 * p + d
        np.testing.assert_array_equal(np.array(local), full[2 * idx:2 * idx + 2])
    r0 = four["batch_rows"]
    np.testing.assert_array_equal(r0["gathered"], full)
    np.testing.assert_array_equal(r0["full_tensor"], full)
    np.testing.assert_array_equal(r0["grad"], 4 * 2 * full[:2])


def test_train_cli_on_two_ranks(tmp_path):
    """``python -m repro_torch.launch.train --smoke --device cpu --nproc 2``:
    two gloo ranks on a (data=2, model=1) mesh, rank 0's lines."""
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"), "OMP_NUM_THREADS": "1"}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "stablelm_3b", "--smoke",
         "--steps", "2", "--seq-len", "16", "--global-batch", "4", "--fsdp", "--device", "cpu",
         "--nproc", "2", "--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "2"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    assert lines[0].startswith("arch stablelm_3b_smoke (dense)")
    assert lines[1].startswith("trained 2 steps")
    rec = json.loads(lines[2])
    assert rec["mesh"] == {"data": 2, "model": 1} and rec["fsdp"] is True
    assert len(rec["losses"]) == 2 and np.isfinite(rec["losses"]).all()
    assert sorted(os.listdir(tmp_path / "ck")) == ["step_00000002"]
