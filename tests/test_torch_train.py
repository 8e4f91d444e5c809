"""The port's training path against the JAX package, on the CPU.

The loss of every family, its gradients and one AdamW update are held
against the reference's ``jax.value_and_grad(Model.train_loss)`` and
``adamw_update`` called without a mesh (the reference's ``Trainer.run()``
does not run on this tree).  Inputs and weights are made with numpy from a
seed and carried with ``repro_torch.convert``; models run at their
``REDUCED`` size in float32.  Tolerances: the loss 1e-5, the gradients 1e-4
of their global norm, ``adamw_update`` on identical inputs 1e-6.  The
checkpoint layout is held both ways between the two packages, and the
port's ``Trainer.run()`` is held to itself: the loss falls, a restart
replays bit for bit, and two microbatches give what one batch gives.
"""

import dataclasses
import math
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
import repro_torch.models as models
from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.checkpoint import restore_tree as jrestore_tree
from repro.checkpoint import save_tree as jsave_tree
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLM as JSyntheticLM
from repro.models import Model as JModel
from repro.models import hybrid as jhybrid
from repro.models import transformer as jtransformer
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jadamw_init
from repro.optim import adamw_update as jadamw_update
from repro.optim import cosine_schedule as jcosine_schedule
from repro.optim import global_norm as jglobal_norm
from repro_torch import convert, obs
from repro_torch.checkpoint import CheckpointManager, restore_tree, save_tree
from repro_torch.data import DataConfig, SyntheticLM, make_batch_shapes
from repro_torch.models import (Model, encdec, hybrid, param_axes, param_shapes, transformer,
                                zamba2)
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, cosine_schedule, global_norm
from repro_torch.runtime import StragglerDetector, TrainConfig, Trainer

torch.set_num_threads(1)

#: one architecture of each family
FAMILIES = {"dense": "stablelm_3b", "moe": "qwen2_moe_a2_7b", "vlm": "qwen2_vl_2b",
            "ssm": "mamba2_370m", "hybrid": "zamba2_2_7b", "audio": "whisper_large_v3"}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _configs(arch, dtype=torch.float32):
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    tcfg = dataclasses.replace(tconfigs.reduced_config(arch), dtype=dtype)
    jcfg = dataclasses.replace(jconfigs.reduced_config(arch), dtype=jdt)
    return tcfg, jcfg


def _leaf_std(leaf, shape):
    if leaf.startswith("ln") or leaf.startswith("b") or leaf in (
            "norm", "final_ln", "enc_ln", "conv_b", "dt_bias"):
        return 0.1
    if leaf == "conv_w":
        return 0.2
    if leaf == "embed":
        return 0.02
    return 1.0 / math.sqrt(shape[-2])


def _weights(tcfg, seed=0):
    """The reference's tree as float32 numpy arrays for any family."""
    rng = np.random.default_rng(seed)
    flat = {}
    for name, shape in param_shapes(tcfg).items():
        leaf = name.rsplit(".", 1)[-1]
        noise = rng.standard_normal(shape)
        if leaf == "a_log":
            arr = np.log(np.linspace(1.0, 16.0, shape[-1])) + 0.1 * noise
        elif leaf == "d_skip":
            arr = 1.0 + 0.1 * noise
        else:
            arr = noise * _leaf_std(leaf, shape)
        flat[name] = arr.astype(np.float32)
    return convert.params_to_reference({k: torch.from_numpy(v) for k, v in flat.items()})


def _both(arch, attn_impl="chunked", remat="none", seed=0):
    tcfg, jcfg = _configs(arch)
    tree = _weights(tcfg, seed)
    model = Model(tcfg, attn_impl=attn_impl, device="cpu", remat=remat)
    model.load_state_dict(convert.params_from_reference(tree, tcfg, device="cpu"))
    for p in model.parameters():
        p.requires_grad_(True)
    jparams = jax.tree.map(jnp.asarray, tree)
    return model, JModel(jcfg, attn_impl=attn_impl, remat=remat), jparams


def _batch(cfg, B=2, S=24, seed=1, masked=0):
    """Numpy inputs of ``train_loss``; the last ``masked`` targets of each row
    are -1 (not counted)."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, cfg.vocab, size=(B, S)).astype(np.int32)
    targets = rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    if masked:
        targets[:, -masked:] = -1
    batch = {"tokens": tokens, "targets": targets}
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.standard_normal((B, 8, cfg.d_model)).astype(np.float32)
        pos = np.arange(S, dtype=np.int32)[None, :, None].repeat(B, 0).repeat(3, 2)
        pos[:, :8, 1] = np.arange(8) // 4
        pos[:, :8, 2] = np.arange(8) % 4
        batch["mrope_positions"] = pos
    if cfg.family == "audio":
        batch["frame_embeds"] = rng.standard_normal((B, 20, cfg.d_model)).astype(np.float32)
    return batch


def _loss_and_grads(model, jmodel, jparams, batch):
    loss = model.train_loss({k: torch.from_numpy(v) for k, v in batch.items()})
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
    jloss, jgrads = jax.value_and_grad(jmodel.train_loss)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    jflat = convert._flatten(jax.tree.map(np.asarray, jgrads))
    return loss, dict(zip(names, grads)), jloss, jflat


def _hold_grads(grads, jflat, rel=1e-4):
    assert set(grads) == set(jflat)
    norm = math.sqrt(sum(float(np.square(g).sum()) for g in jflat.values()))
    assert norm > 0
    for name, g in grads.items():
        err = float(np.abs(_np(g) - jflat[name]).max())
        assert err <= rel * norm, (name, err, norm)


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S,chunk,masked", [(24, 512, 0), (40, 16, 5), (32, 8, 32)])
def test_lm_loss_matches_reference(S, chunk, masked):
    """Chunks that do and do not divide the sequence, masked targets, and a
    batch with every target masked (the count floored at 1)."""
    for tied in (False, True):
        tcfg, jcfg = _configs("stablelm_3b")
        tcfg = dataclasses.replace(tcfg, tie_embeddings=tied)
        jcfg = dataclasses.replace(jcfg, tie_embeddings=tied)
        tree = _weights(tcfg)
        rng = np.random.default_rng(3)
        h = rng.standard_normal((2, S, tcfg.d_model)).astype(np.float32)
        tgt = rng.integers(0, tcfg.vocab, size=(2, S)).astype(np.int32)
        if masked:
            tgt[:, -masked:] = -1
        params = {k: torch.from_numpy(v) for k, v in tree.items() if not isinstance(v, dict)}
        got = transformer.lm_loss(tcfg, params, torch.from_numpy(h), torch.from_numpy(tgt),
                                  chunk=chunk)
        want = jtransformer.lm_loss(jcfg, jax.tree.map(jnp.asarray, tree), jnp.asarray(h),
                                    jnp.asarray(tgt), chunk=chunk)
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-5)
        if masked == S:
            assert float(got) == 0.0


def test_lm_head_loss_matches_reference():
    tcfg, jcfg = _configs("zamba2_2_7b")
    tree = _weights(tcfg)
    rng = np.random.default_rng(4)
    h = rng.standard_normal((2, 30, tcfg.d_model)).astype(np.float32)
    tgt = rng.integers(-1, tcfg.vocab, size=(2, 30)).astype(np.int32)
    got = hybrid.lm_head_loss(tcfg, {"embed": torch.from_numpy(tree["embed"])},
                              torch.from_numpy(h), torch.from_numpy(tgt), chunk=16)
    want = jhybrid.lm_head_loss(jcfg, {"embed": jnp.asarray(tree["embed"])}, jnp.asarray(h),
                                jnp.asarray(tgt), chunk=16)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-5)


def test_lm_loss_keeps_no_chunk_of_logits_for_backward():
    """Each chunk step is checkpointed: what backward keeps does not grow
    with the vocabulary's logits (the reason the reference checkpoints it)."""
    tcfg, _ = _configs("stablelm_3b")
    tcfg = dataclasses.replace(tcfg, vocab=4096)
    h = torch.randn(2, 64, tcfg.d_model, requires_grad=True)
    w = torch.randn(tcfg.d_model, tcfg.vocab, requires_grad=True)
    tgt = torch.randint(0, tcfg.vocab, (2, 64))
    saved = []

    def pack(t):
        saved.append(t.numel())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = transformer.lm_loss(tcfg, {"lm_head": w}, h, tgt, chunk=16)
    assert max(saved) < 2 * 16 * tcfg.vocab, max(saved)   # never a chunk's logits
    loss.backward()
    assert h.grad is not None and torch.isfinite(w.grad).all()


@pytest.mark.parametrize("family", list(FAMILIES))
def test_train_loss_and_grads_match_reference(family):
    """Every family's ``train_loss``: the loss to 1e-5 and each gradient to
    1e-4 of the gradients' global norm; ssm / audio through the tied head."""
    model, jmodel, jparams = _both(FAMILIES[family])
    batch = _batch(model.cfg, masked=3)
    loss, grads, jloss, jflat = _loss_and_grads(model, jmodel, jparams, batch)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5, atol=1e-5)
    _hold_grads(grads, jflat)


@pytest.mark.parametrize("family", ["dense", "hybrid", "audio", "ssm"])
def test_remat_changes_nothing(family):
    """``remat="full"`` (``torch.utils.checkpoint`` around each layer body;
    the ssm family, as in the reference, recomputes none) gives the loss and
    gradients of ``"none"``, as the reference's does."""
    model, _, _ = _both(FAMILIES[family])
    batch = {k: torch.from_numpy(v) for k, v in _batch(model.cfg).items()}
    params = [p for _, p in model.named_parameters()]
    loss = model.train_loss(batch)
    grads = torch.autograd.grad(loss, params)
    for remat in ("full", "dots"):
        model.remat = remat
        loss2 = model.train_loss(batch)
        grads2 = torch.autograd.grad(loss2, params)
        assert float(loss2) == pytest.approx(float(loss), rel=1e-6, abs=1e-6)
        for a, b in zip(grads, grads2):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-7)
    with pytest.raises(ValueError, match="remat"):
        Model(model.cfg, device="cpu", remat="some")


def _grad_nodes(loss, name):
    """The nodes of ``loss``'s backward graph named ``name``."""
    seen, todo, found = set(), [loss.grad_fn], []
    while todo:
        node = todo.pop()
        if node is None or id(node) in seen:
            continue
        seen.add(id(node))
        if node.name() == name:
            found.append(node)
        todo.extend(fn for fn, _ in node.next_functions)
    return found


def _stacked(model):
    """The names of the model's layer-stacked leaves, by their stacked groups."""
    groups = {}
    for name, axes in param_axes(model.cfg).items():
        if axes[:1] == ("layers",):
            groups.setdefault(name.rpartition(".")[0], []).append(name)
    return groups


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("family", ["dense", "moe", "ssm", "hybrid", "audio"])
def test_stacked_leaves_grads_equal_the_per_layer_select(family, remat, monkeypatch):
    """Each stacked leaf unbound once a forward (``layer_views``) gives the
    loss and every gradient of the old per-layer ``w[i]``
    (``chip_smoke.per_layer_select``), bit for bit: each slice's gradient is
    stacked instead of summed with exact zeros."""
    from chip_smoke import per_layer_select

    cfg = tconfigs.reduced_config(FAMILIES[family])
    model = Model(cfg, device="cpu", remat=remat).init(seed=0)
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    if "frame_embeds" in batch:
        batch["frame_embeds"] = batch["frame_embeds"].bfloat16()

    def loss_and_grads():
        loss = model.train_loss(batch)
        return loss, dict(zip(params, torch.autograd.grad(loss, list(params.values()))))

    loss, grads = loss_and_grads()
    for mod in (models.common, transformer, encdec, hybrid, zamba2):
        monkeypatch.setattr(mod, "layer_views", per_layer_select)
    old_loss, old_grads = loss_and_grads()
    # one unbind a stacked leaf, however many pieces of the forward read its group
    n_stacked = sum(len(names) for names in _stacked(model).values())
    assert n_stacked and len(_grad_nodes(loss, "UnbindBackward0")) == n_stacked
    assert not _grad_nodes(old_loss, "UnbindBackward0")
    assert torch.equal(loss, old_loss)
    assert all(torch.equal(g, old_grads[k]) for k, g in grads.items())


@pytest.mark.parametrize("remat", ["none", "full"])
def test_backward_holds_one_unbind_per_stacked_leaf(remat):
    """stablelm's backward takes each stacked leaf's gradient from one
    ``UnbindBackward0`` and from no ``SelectBackward0``; with telemetry on,
    ``params.stacks_unbound`` counts one a stacked group a forward."""
    cfg = tconfigs.reduced_config("stablelm_3b")
    model = Model(cfg, device="cpu", remat=remat).init(seed=0)
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    stacked = {id(params[n]): n for names in _stacked(model).values() for n in names}
    obs.reset()
    obs.enable()
    try:
        loss = model.train_loss(batch)
        model.train_loss(batch)
        counters = obs.metrics().snapshot()
    finally:
        obs.disable()
        obs.reset()

    def leaves(node):
        return [stacked.get(id(getattr(fn, "variable", None))) for fn, _ in node.next_functions
                if fn is not None]

    unbound = [n for node in _grad_nodes(loss, "UnbindBackward0") for n in leaves(node)]
    assert sorted(unbound) == sorted(stacked.values())
    assert not any(n for node in _grad_nodes(loss, "SelectBackward0") for n in leaves(node))
    assert counters == {"params.stacks_unbound": 2 * len(_stacked(model)),
                        "attn.chunked_loop_calls": 2 * cfg.n_layers}


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_arch_smoke_train_step(arch):
    """Reduced config, fresh weights: one loss and its gradients; finite, and
    the loss near ln(vocab) (the reference's ``test_arch_smoke_train_step``)."""
    cfg = tconfigs.reduced_config(arch)
    model = Model(cfg, attn_impl="xla", device="cpu").init(seed=0)
    for p in model.parameters():
        p.requires_grad_(True)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, S=32).items()}
    for k in ("patch_embeds", "frame_embeds"):
        if k in batch:
            batch[k] = batch[k].bfloat16()
    loss = model.train_loss(batch)
    assert loss.shape == () and torch.isfinite(loss)
    assert abs(float(loss) - math.log(cfg.vocab)) < 1.5
    grads = torch.autograd.grad(loss, list(model.parameters()))
    assert all(bool(torch.isfinite(g.float()).all()) for g in grads), arch


def test_the_kernels_refuse_gradients_and_do_not_fall_back():
    """Training runs ``"xla"`` / ``"chunked"``; the CUDA kernels are forward
    only, and their wrappers raise under grad even where the tensors lie on
    the CPU (they never hand the call to the plain version)."""
    model, _, _ = _both("stablelm_3b", attn_impl="hopper")
    batch = {k: torch.from_numpy(v) for k, v in _batch(model.cfg).items()}
    with pytest.raises(RuntimeError, match="forward only"):
        model.train_loss(batch)
    with torch.no_grad():
        assert torch.isfinite(model.train_loss(batch))
    ssm, _, _ = _both("mamba2_370m")
    ssm.ssd_impl = "hopper"
    with pytest.raises(RuntimeError):
        ssm.train_loss({k: torch.from_numpy(v) for k, v in _batch(ssm.cfg).items()})
    cfg = tconfigs.reduced_config("stablelm_3b")
    with pytest.raises(ValueError, match="no backward"):
        Trainer(cfg, AdamWConfig(), TrainConfig(attn_impl="hopper"),
                DataConfig(vocab=cfg.vocab, seq_len=8, global_batch=2), device="cpu")


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def test_cosine_schedule_matches_reference():
    for cfg in (AdamWConfig(), AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=8),
                AdamWConfig(warmup_steps=0, total_steps=1)):
        jcfg = JAdamWConfig(**dataclasses.asdict(cfg))
        for step in (0, 1, 2, 3, 50, 100, 101, 5000, 9999, 10_000, 20_000):
            got = cosine_schedule(cfg, torch.tensor(step, dtype=torch.int32))
            want = jcosine_schedule(jcfg, jnp.int32(step))
            assert got.dtype == torch.float32
            np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-12)
    cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=110, min_lr_ratio=0.1)
    assert float(cosine_schedule(cfg, torch.tensor(5))) == pytest.approx(0.5)
    assert float(cosine_schedule(cfg, torch.tensor(10))) == pytest.approx(1.0)
    assert float(cosine_schedule(cfg, torch.tensor(200))) == pytest.approx(0.1)


@pytest.mark.parametrize("grad_scale", [1.0, 300.0])
def test_adamw_update_matches_reference_on_identical_inputs(grad_scale):
    """Three updates fed the same gradients on both sides (the reference's
    own, from ``jax.value_and_grad``), clipped or not: parameters, moments,
    count and metrics to 1e-6.  The port's update writes into the tensors it
    is given."""
    model, jmodel, jparams = _both("stablelm_3b")
    _, _, _, jflat = _loss_and_grads(model, jmodel, jparams, _batch(model.cfg))
    cfg = AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=5)
    jcfg = JAdamWConfig(**dataclasses.asdict(cfg))
    params = {k: p.detach().clone() for k, p in model.named_parameters()}
    state, jstate = adamw_init(params), jadamw_init(jparams)
    ids = [{k: id(v) for k, v in part.items()} for part in (params, state["mu"], state["nu"])]
    rng = np.random.default_rng(5)
    for _ in range(3):
        noise = {k: (g + 0.1 * rng.standard_normal(g.shape) * np.abs(g).mean()).astype(np.float32)
                 * grad_scale for k, g in jflat.items()}
        grads = {k: torch.from_numpy(v) for k, v in noise.items()}
        jgrads = jax.tree.map(jnp.asarray, convert.params_to_reference(grads))
        params, state, metrics = adamw_update(cfg, params, grads, state)
        jparams, jstate, jmetrics = jadamw_update(jcfg, jparams, jgrads, jstate)
        jp, jmu = convert._flatten(jax.tree.map(np.asarray, jparams)), \
            convert._flatten(jax.tree.map(np.asarray, jstate["mu"]))
        jnu = convert._flatten(jax.tree.map(np.asarray, jstate["nu"]))
        for k in params:
            np.testing.assert_allclose(params[k].numpy(), jp[k], rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(state["mu"][k].numpy(), jmu[k], rtol=1e-6, atol=1e-9)
            np.testing.assert_allclose(state["nu"][k].numpy(), jnu[k], rtol=1e-6, atol=1e-12)
        assert int(state["count"]) == int(jstate["count"])
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(metrics[key]), float(jmetrics[key]), rtol=1e-6)
    assert ids == [{k: id(v) for k, v in part.items()}
                   for part in (params, state["mu"], state["nu"])]


def test_adamw_state_and_global_norm():
    params = {"a": torch.ones(3, 2, dtype=torch.bfloat16), "b": torch.zeros(4)}
    state = adamw_init(params)
    assert state["count"].dtype == torch.int32 and int(state["count"]) == 0
    assert all(m.dtype == torch.float32 and m.shape == params[k].shape
               for part in ("mu", "nu") for k, m in state[part].items())
    rng = np.random.default_rng(0)
    tree = {"a": rng.standard_normal((3, 5)).astype(np.float32),
            "b": rng.standard_normal(7).astype(np.float32)}
    np.testing.assert_allclose(float(global_norm({k: torch.from_numpy(v) for k, v in tree.items()})),
                               float(jglobal_norm(jax.tree.map(jnp.asarray, tree))), rtol=1e-6)
    # bfloat16 parameters keep their dtype; the step is computed in float32
    new, _, _ = adamw_update(AdamWConfig(warmup_steps=0), params,
                             {k: torch.ones_like(v) for k, v in params.items()}, state)
    assert new["a"].dtype == torch.bfloat16 and new["b"].dtype == torch.float32
    assert float(new["b"].abs().max()) > 0    # moved, in place


def test_one_step_matches_the_references_unmeshed_step():
    """The reference's step without a mesh (``value_and_grad`` of
    ``Model.train_loss``, then ``adamw_update``) against the trainer's
    ``step``, in parts: the loss to 1e-5, the gradients to 1e-4 of their
    norm, and the update from the same parameters.  Adam's first step moves
    an element by ``lr * g / (|g| + eps)``: where a gradient is near zero, the
    two frameworks' roundings of it (``dg``) move the element by up to
    ``2 lr |dg| / |g|``, so each element is held to that bound (plus 1e-4 of
    lr), and at most 1e-3 of the elements may part by more than 1e-3 of lr.
    ``adamw_update`` itself is held at 1e-6 on identical inputs above."""
    cfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=8)
    tcfg, jcfg = _configs("stablelm_3b")
    tree = _weights(tcfg)
    tr = Trainer(tcfg, cfg, TrainConfig(steps=1, checkpoint_every=0, attn_impl="chunked"),
                 DataConfig(vocab=tcfg.vocab, seq_len=24, global_batch=2), device="cpu")
    params, opt = tr.init_state()
    with torch.no_grad():
        for k, v in convert.params_from_reference(tree, tcfg, device="cpu").items():
            params[k].copy_(v)
    batch = _batch(tcfg)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    _, grads = tr._grads(params, tbatch)
    opt, metrics = tr.step(params, opt, tbatch)
    jmodel = JModel(jcfg, attn_impl="chunked")
    jparams = jax.tree.map(jnp.asarray, tree)
    jloss, jgrads = jax.value_and_grad(jmodel.train_loss)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    jnew, jopt, jmetrics = jadamw_update(JAdamWConfig(**dataclasses.asdict(cfg)), jparams,
                                         jgrads, jadamw_init(jparams))
    np.testing.assert_allclose(float(metrics["loss"]), float(jloss), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(jmetrics["grad_norm"]),
                               rtol=1e-4)
    lr = float(jmetrics["lr"])
    assert float(metrics["lr"]) == pytest.approx(lr, rel=1e-6)
    jflat = convert._flatten(jax.tree.map(np.asarray, jnew))
    jg = convert._flatten(jax.tree.map(np.asarray, jgrads))
    _hold_grads(grads, jg)
    eps, apart, total = cfg.eps, 0, 0
    for k, p in params.items():
        diff = np.abs(p.detach().numpy() - jflat[k])
        dg = np.abs(grads[k].numpy() - jg[k])
        allowed = lr * (2 * dg / (np.abs(jg[k]) + eps) + 1e-4) + 1e-7
        assert (diff <= allowed).all(), (k, float((diff - allowed).max()), lr)
        apart += int((diff > 1e-3 * lr).sum())
        total += diff.size
    assert apart <= 1e-3 * total, (apart, total)
    assert int(opt["count"]) == 1


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------


def test_data_pipeline_determinism_and_packing():
    cfg = DataConfig(vocab=1000, seq_len=64, global_batch=8, seed=11)
    pipe = SyntheticLM(cfg)
    b1, b2 = pipe.batch(5), pipe.batch(5)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    assert b1["tokens"].shape == (8, 64)
    assert (b1["tokens"] >= 0).all() and (b1["tokens"] < 1000).all()
    h0 = SyntheticLM(cfg, host_id=0, n_hosts=2).batch(5)
    h1 = SyntheticLM(cfg, host_id=1, n_hosts=2).batch(5)
    assert h0["tokens"].shape == (4, 64)
    assert not np.array_equal(h0["tokens"], h1["tokens"])


@pytest.mark.parametrize("kw", [dict(vocab=1000, seq_len=64, global_batch=8, seed=11),
                                dict(vocab=50304, seq_len=512, global_batch=2, seed=7),
                                dict(vocab=256, seq_len=32, global_batch=4, seed=7,
                                     mean_doc_len=8, eos=3)])
def test_data_pipeline_is_the_references_bit_for_bit(kw):
    for host_id, n_hosts in ((0, 1), (1, 2)):
        got = SyntheticLM(DataConfig(**kw), host_id, n_hosts)
        want = JSyntheticLM(JDataConfig(**kw), host_id, n_hosts)
        for i in (0, 3):
            a, b = got.batch(i), want.batch(i)
            assert sorted(a) == sorted(b) == ["targets", "tokens"]
            for k in a:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
    from repro.data import make_batch_shapes as jshapes
    for fam in ("dense", "vlm", "audio"):
        assert make_batch_shapes(fam, 4, 16, 64, 8, 30) == jshapes(fam, 4, 16, 64, 8, 30)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def test_checkpoint_atomicity_and_keep_k(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = {"w": torch.arange(8.0), "nested": {"b": torch.ones((3, 3))}}
    for step in (1, 2, 3, 4):
        mgr.save(step, tree, extra={"tag": step}, async_=False)
    steps = sorted(int(n.split("_")[1]) for n in os.listdir(tmp_path) if n.startswith("step_"))
    assert steps == [3, 4]  # keep-2 GC
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]
    restored, extra = mgr.restore(tree)
    assert extra["step"] == 4 and extra["tag"] == 4
    np.testing.assert_array_equal(restored["w"].numpy(), np.arange(8.0))
    # a save cut short leaves only its .tmp directory, which nothing reads;
    # a leaf that cannot be stored fails before anything is written
    os.makedirs(tmp_path / "step_00000005.tmp")
    (tmp_path / "step_00000005.tmp" / "w.npy").write_bytes(b"cut")
    with pytest.raises(KeyError):
        mgr.save(6, {"w": torch.zeros(2, dtype=torch.complex64)}, async_=False)
    assert mgr.latest_step() == 4
    assert mgr.restore(tree)[1]["step"] == 4


def test_checkpoint_async_then_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    w = torch.ones((64, 64))
    mgr.save(10, {"w": w}, async_=True)
    w.add_(1.0)     # the snapshot was taken before save() returned
    mgr.wait()
    assert mgr.latest_step() == 10
    assert torch.equal(mgr.restore({"w": w})[0]["w"], torch.ones((64, 64)))


def test_checkpoint_shape_mismatch_rejected(tmp_path):
    path = str(tmp_path / "ck")
    save_tree(path, {"w": np.ones((4,))})
    with pytest.raises(ValueError):
        restore_tree(path, {"w": torch.ones((5,))})
    with pytest.raises(KeyError):
        restore_tree(path, {"v": torch.ones((4,))})
    # a None sharding places nothing: the leaf lands as ``like``'s does
    out, _ = restore_tree(path, {"w": torch.ones((4,))}, shardings={"w": None})
    assert torch.equal(out["w"], torch.ones(4, dtype=torch.float64))


def _mixed_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"params": {"embed": rng.standard_normal((6, 4)).astype(np.float32),
                       "layers": {"wq": rng.standard_normal((2, 4, 4)).astype(np.float32)}},
            "opt": {"count": np.int32(7),
                    "mu": {"embed": rng.standard_normal((6, 4)).astype(np.float32)}},
            "pair": (np.arange(3, dtype=np.int32), np.ones(2, np.float32))}


def test_a_reference_checkpoint_restores_into_the_port(tmp_path):
    """Written by the reference (bfloat16 leaves as raw bits), read by the
    port bit for bit, each leaf in its saved dtype."""
    tree = _mixed_tree()
    jtree = jax.tree.map(jnp.asarray, tree)
    jtree["params"] = jax.tree.map(lambda x: x.astype(jnp.bfloat16), jtree["params"])
    mgr = JCheckpointManager(str(tmp_path), keep=2)
    mgr.save(3, jtree, extra={"data_index": 3}, async_=False)
    like = {"params": {"embed": torch.zeros(6, 4, dtype=torch.bfloat16),
                       "layers": {"wq": torch.zeros(2, 4, 4, dtype=torch.bfloat16)}},
            "opt": {"count": torch.zeros((), dtype=torch.int32), "mu": {"embed": torch.zeros(6, 4)}},
            "pair": (torch.zeros(3, dtype=torch.int32), torch.zeros(2))}
    got, extra = CheckpointManager(str(tmp_path)).restore(like)
    assert extra == {"data_index": 3, "step": 3}
    assert got["params"]["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["params"]["embed"].float().numpy(),
                                  np.asarray(jtree["params"]["embed"].astype(jnp.float32)))
    np.testing.assert_array_equal(got["params"]["layers"]["wq"].float().numpy(),
                                  np.asarray(jtree["params"]["layers"]["wq"].astype(jnp.float32)))
    assert got["opt"]["count"].dtype == torch.int32 and got["opt"]["count"].shape == ()
    assert int(got["opt"]["count"]) == 7
    np.testing.assert_array_equal(got["opt"]["mu"]["embed"].numpy(), tree["opt"]["mu"]["embed"])
    assert isinstance(got["pair"], tuple) and got["pair"][0].tolist() == [0, 1, 2]


def test_a_port_checkpoint_restores_into_the_reference(tmp_path):
    tree = _mixed_tree(1)
    ttree = {"params": {k: torch.from_numpy(v).bfloat16() if not isinstance(v, dict) else
                        {kk: torch.from_numpy(vv).bfloat16() for kk, vv in v.items()}
                        for k, v in tree["params"].items()},
             "opt": {"count": torch.tensor(7, dtype=torch.int32),
                     "mu": {"embed": torch.from_numpy(tree["opt"]["mu"]["embed"])}},
             "pair": tuple(torch.from_numpy(v) for v in tree["pair"])}
    path = str(tmp_path / "step_00000009")
    save_tree(path, ttree, extra={"data_index": 9})
    jlike = jax.tree.map(jnp.asarray, tree)
    jlike["params"] = jax.tree.map(lambda x: x.astype(jnp.bfloat16), jlike["params"])
    got, extra = jrestore_tree(path, jlike)
    assert extra == {"data_index": 9}
    assert got["params"]["embed"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(got["params"]["embed"].astype(jnp.float32)),
                                  ttree["params"]["embed"].float().numpy())
    assert int(got["opt"]["count"]) == 7 and got["opt"]["count"].dtype == jnp.int32
    np.testing.assert_array_equal(np.asarray(got["pair"][1]), tree["pair"][1])
    # and the reference's manager finds it as its latest step
    assert JCheckpointManager(str(tmp_path)).latest_step() == 9
    # the reference's own writer gives the same files and manifest
    jsave_tree(str(tmp_path / "ref"), jlike, extra={"data_index": 9})
    assert sorted(os.listdir(path)) == sorted(os.listdir(tmp_path / "ref"))


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------


def _mk_trainer(tmp_path, steps=6, ckpt_every=3, arch="stablelm_3b", dtype=torch.bfloat16,
                seq_len=32, global_batch=4, seed=7, **tkw):
    cfg = dataclasses.replace(tconfigs.reduced_config(arch), dtype=dtype)
    tcfg = TrainConfig(steps=steps, checkpoint_every=ckpt_every,
                       checkpoint_dir=str(tmp_path / "ckpt"), attn_impl="xla", **tkw)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=seq_len, global_batch=global_batch, seed=seed)
    return Trainer(cfg, AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=steps), tcfg, dcfg,
                   device="cpu")


def test_training_loss_decreases(tmp_path):
    tr = _mk_trainer(tmp_path, steps=30, ckpt_every=100)
    out = tr.run()
    losses = out["losses"]
    assert len(losses) == 30 and out["final_step"] == 30 and out["restarts"] == 0
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    assert last < first - 0.2, (first, last)
    assert len(out["step_seconds"]) == 30
    # the final save (step 30 is not a multiple of 100, but the last step)
    assert tr.ckpt.latest_step() == 30


@pytest.mark.parametrize("remat", ["none", "full"])
def test_checkpoint_restart_is_bit_exact(tmp_path, remat):
    out1 = _mk_trainer(tmp_path / "a", steps=8, ckpt_every=4, remat=remat).run()
    boom = {"armed": True}

    def injector(step):
        if step == 5 and boom["armed"]:
            boom["armed"] = False
            raise RuntimeError("injected node failure")

    tr2 = _mk_trainer(tmp_path / "b", steps=8, ckpt_every=4, remat=remat)
    out2 = tr2.run(fault_injector=injector)
    assert out2["restarts"] == 1
    # steps 0-4, the failure at 5, then 4-7 replayed from the step-4 checkpoint
    assert len(out2["losses"]) == 5 + 4
    assert out2["losses"][4] == out2["losses"][5] and out1["losses"][-1] == out2["losses"][-1]
    for k, p in out1["params"].items():
        assert torch.equal(p, out2["params"][k]), k
    for part in ("mu", "nu"):
        for k, m in out1["opt_state"][part].items():
            assert torch.equal(m, out2["opt_state"][part][k]), (part, k)
    assert int(out1["opt_state"]["count"]) == int(out2["opt_state"]["count"]) == 8


def test_restart_waits_for_the_checkpoint_in_flight(tmp_path, monkeypatch):
    """A failure while the step-4 checkpoint is still being written: the
    restart waits for it and resumes from step 4, not from step 0 (the
    reference reads the latest step without waiting)."""
    from repro_torch.checkpoint import manager

    write = manager._write

    def slow(*args):
        time.sleep(0.5)
        write(*args)

    monkeypatch.setattr(manager, "_write", slow)
    boom = {"armed": True}

    def injector(step):
        if step == 5 and boom["armed"]:
            boom["armed"] = False
            raise RuntimeError("injected node failure")

    out = _mk_trainer(tmp_path, steps=8, ckpt_every=4).run(fault_injector=injector)
    assert out["restarts"] == 1 and len(out["losses"]) == 5 + 4


def test_grad_accumulation_equivalence(tmp_path):
    """microbatches=2 matches microbatches=1 numerically (fp32)."""
    outs = []
    for mb in (1, 2):
        tr = _mk_trainer(tmp_path / f"mb{mb}", steps=3, ckpt_every=100, dtype=torch.float32,
                         seq_len=16, seed=3, microbatches=mb)
        outs.append(tr.run())
    np.testing.assert_allclose(outs[0]["losses"], outs[1]["losses"], rtol=2e-4, atol=2e-4)
    for k, p in outs[0]["params"].items():
        np.testing.assert_allclose(p.numpy(), outs[1]["params"][k].numpy(), rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="microbatches"):
        _mk_trainer(tmp_path / "bad", microbatches=3)


def test_a_reference_checkpoint_resumes_in_the_port_trainer(tmp_path):
    """The reference's trainer tree (``params``, ``opt`` with ``mu``, ``nu``,
    ``count``; ``data_index``) written by the reference's manager: the
    port's trainer resumes from it with those exact values."""
    tr = _mk_trainer(tmp_path, steps=6, ckpt_every=100)
    cfg = tr.model_cfg
    tree = _weights(cfg, seed=4)
    jparams = jax.tree.map(lambda x: jnp.asarray(x).astype(jnp.bfloat16), tree)
    jopt = jadamw_init(jparams)
    jopt = {**jopt, "mu": jax.tree.map(lambda m: m + 0.5, jopt["mu"]), "count": jnp.int32(4)}
    JCheckpointManager(str(tmp_path / "ckpt")).save(
        4, {"params": jparams, "opt": jopt}, extra={"data_index": 4}, async_=False)
    params, opt = tr.init_state()
    opt, step = tr._restore(params, opt)
    assert step == 4 and int(opt["count"]) == 4
    want = convert.params_from_reference(tree, cfg, device="cpu")
    for k, p in params.items():
        assert p.dtype == torch.bfloat16 and torch.equal(p.detach(), want[k]), k
        assert torch.equal(opt["mu"][k], torch.full(p.shape, 0.5))
    out = tr.run()
    assert out["final_step"] == 6 and len(out["losses"]) == 2


def test_straggler_detector():
    det = StragglerDetector(z_threshold=3.0, warmup=5)
    for _ in range(20):
        assert not det.observe(0.1)
    assert det.observe(10.0)  # a 100x step is a straggler
    assert det.flagged == 1


def test_straggler_hook_fires(tmp_path):
    """The detector->callback wiring, fed deterministic step times."""
    events = []
    cfg = tconfigs.reduced_config("stablelm_3b")
    tcfg = TrainConfig(steps=4, checkpoint_every=100, checkpoint_dir=str(tmp_path / "c"),
                       attn_impl="xla", straggler_zscore=3.0, straggler_warmup=4)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4)
    tr = Trainer(cfg, AdamWConfig(), tcfg, dcfg, device="cpu",
                 straggler_callback=lambda step, dt: events.append((step, dt)))
    tr._observe_step(0, 5.0)  # the first step (ignored by design)
    for s in range(1, 20):
        tr._observe_step(s, 0.1 + 0.001 * (s % 3))
    tr._observe_step(20, 10.0)
    assert events and events[-1][0] == 20
    assert tr.detector.flagged == 1


def test_what_needs_more_than_one_device_raises(tmp_path):
    """fsdp needs a mesh and raises without one; on a one-rank ``gloo`` mesh
    an fsdp run saves a checkpoint that restores without a mesh and, after
    ``remesh``, onto the mesh again, bit for bit, and a restore onto given
    shardings gives DTensors; the trainer's entry point defaults to the GPU
    and never falls back."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.mesh import make_host_mesh, start_process_group
    from repro_torch.sharding import Sharding

    cfg = tconfigs.reduced_config("stablelm_3b")
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=8, global_batch=2)
    with pytest.raises(ValueError, match="mesh"):
        Trainer(cfg, AdamWConfig(), TrainConfig(fsdp=True, checkpoint_dir=str(tmp_path)), dcfg,
                device="cpu")
    start_process_group("cpu", 0, 1, str(tmp_path / "store"))
    try:
        mesh = make_host_mesh()
        ck = str(tmp_path / "ck")
        out = Trainer(cfg, AdamWConfig(), TrainConfig(steps=2, checkpoint_every=2, checkpoint_dir=ck,
                                                      fsdp=True), dcfg, device="cpu", mesh=mesh).run()
        tr = Trainer(cfg, AdamWConfig(), TrainConfig(checkpoint_dir=ck), dcfg, device="cpu")
        for target in (None, mesh):
            tr.remesh(target)
            params, opt = tr.init_state()
            opt, step = tr._restore(params, opt)
            assert step == 2
            for k, p in out["params"].items():
                got = params[k].full_tensor() if target is not None else params[k]
                assert torch.equal(got.detach(), p.full_tensor()), k
        state, _ = tr.ckpt.restore({"params": {"final_ln": torch.zeros(cfg.d_model)}}, step=2,
                                   shardings={"params": {"final_ln": Sharding(mesh, (None,))}})
        assert isinstance(state["params"]["final_ln"], DTensor)
    finally:
        dist.destroy_process_group()
    assert [f.name for f in dataclasses.fields(TrainConfig)] == [
        "steps", "microbatches", "checkpoint_every", "checkpoint_dir", "keep_checkpoints",
        "log_every", "seed", "fsdp", "remat", "attn_impl", "straggler_zscore",
        "straggler_warmup"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            Trainer(cfg, AdamWConfig(), TrainConfig(checkpoint_dir=str(tmp_path)), dcfg)
