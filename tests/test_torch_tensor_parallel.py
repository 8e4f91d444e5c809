"""Tensor- and expert-parallel products on the ``model`` axis, on the CPU.

* the plan (``repro_torch.sharding.model_axis`` of
  ``repro_torch.models.split_products``) of every family on the production
  meshes: which products are split and this rank's ranges (heads, K / V
  heads, ``ff``, experts or ``ff_expert``, SSM heads, vocabulary) and how it
  reads each leaf (a mamba layer's segmented ``in_proj`` / ``conv``);
* the dry-run of the ssm, hybrid and audio families on a 4 x 4 fake mesh
  against the count from the shapes;
* the meshed trainer on ``gloo`` ranks (``tests/torch_mesh_ranks.py``, which
  imports no JAX) on ``(data=1, model=2)``, ``(1, 4)`` and ``(2, 2)``, float32,
  for eleven reduced configs (dense, a cut K / V head, the vision prefix, MoE
  with clean expert parallelism and with ``ff_expert``, llama4, a vocabulary
  4 does not divide, mamba2, zamba2, whisper, whisper with heads 4 does not
  divide): the first batch's gradients, 3 steps' losses, gradient norms and
  parameters against the port's un-meshed trainer, the losses against the
  reference's un-meshed step;
* serving on ranks: prefill (whisper: its frames, then a start token) then
  4 greedy decode steps, ``attn_impl`` ``xla`` and ``chunked``, logits and
  tokens against the un-meshed port, with float32 and bfloat16 caches and
  conv states; a logit tied across the ranks' vocabulary blocks resolved to
  the lowest index;
* the work is split: each rank's matrix-product flops by leaf against the
  un-meshed forward's, and the all-gathers it issues over ``model``, named;
  ``ModelAxis.all_sum`` sums forward and backward.
"""

import dataclasses
import json
from fractions import Fraction

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
from repro.models import Model as JModel
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jadamw_init
from repro.optim import adamw_update as jadamw_update
from repro_torch import convert
from repro_torch.launch.mesh import fake_mesh
from repro_torch.models import Model, param_axes, param_shapes, split_products
from repro_torch.sharding import (
    WHOLE, ModelAxis, Segments, default_rules, logical_to_sharding, model_axis, read_range,
)
from test_torch_launch import _close, _params, _spawn, rounding_noise

torch.set_num_threads(1)

CONFIGS = list(ranks.TP_CONFIGS)
MESHES = [f"data{d}_model{m}" for world in (2, 4) for d, m in ranks.TP_MESHES[world]]
SERVED = [m for m in MESHES if m.startswith("data1")]


# ---------------------------------------------------------------------------
# The plan on the production meshes
# ---------------------------------------------------------------------------


@pytest.fixture
def fake():
    """``mesh(shape)``: a ``("data", "model")`` fake mesh, this process rank 0;
    its group is ended after the test."""
    yield lambda shape: fake_mesh(shape, ("data", "model"))
    if dist.is_initialized():
        dist.destroy_process_group()


def _plan(arch, mesh, fsdp=False):
    cfg = tconfigs.get_config(arch)
    like = {k: torch.empty(s, device="meta") for k, s in param_shapes(cfg).items()}
    rules = default_rules(mesh, n_experts=cfg.moe.n_experts if cfg.moe else 0, fsdp=fsdp)
    return model_axis(split_products(cfg),
                      logical_to_sharding(param_axes(cfg), mesh, rules, like=like))


#: rank 0's ranges on 16 x 16, by product: the heads whole where 16 does
#: not divide them (qwen2_7b's 28, llama4's 40, gemma3's 4, qwen2_vl's 12),
#: granite's 2 query heads on one cut K / V head, qwen2_moe's 60 experts
#: over ff_expert (1408 / 16 rows), llama4's 16 one a rank
PLANS_16 = {
    "stablelm_3b": {"heads": (0, 2), "kv_heads": (0, 2), "ff": (0, 432), "vocab": (0, 3144)},
    "gemma3_1b": {"ff": (0, 432), "vocab": (0, 16384)},
    "qwen2_7b": {"ff": (0, 1184), "vocab": (0, 9504)},
    "granite_8b": {"heads": (0, 2), "kv_heads": (0, 1), "ff": (0, 896), "vocab": (0, 3072)},
    "qwen2_moe_a2_7b": {"heads": (0, 1), "kv_heads": (0, 1), "ff_expert": (0, 88),
                        "shared": (0, 352), "vocab": (0, 9496)},
    "llama4_scout_17b_a16e": {"experts": (0, 1), "shared": (0, 512), "vocab": (0, 12628)},
    "qwen2_vl_2b": {"ff": (0, 560), "vocab": (0, 9496)},
}


@pytest.mark.parametrize("arch", list(PLANS_16))
@pytest.mark.parametrize("fsdp", [False, True])
def test_plan_on_the_production_mesh(fake, arch, fsdp):
    """What rank 0 of 16 x 16 computes a share of, fsdp or not (the data
    axis changes no product's split), and how it reads each split leaf."""
    tp = _plan(arch, fake((16, 16)), fsdp)
    assert tp.group.size() == 16
    assert dict(tp.ranges) == PLANS_16[arch]
    cfg = tconfigs.get_config(arch)
    if not tp.splits("heads"):
        assert not any(n.split(".")[-1] in ("wq", "wk", "wv", "wo") for n in tp.takes)
    elif cfg.n_kv_heads % 16:        # granite: the K / V head gathered and cut
        assert tp.takes["layers.wk"] == ("slice", 2, 0, cfg.dh)
    else:
        assert tp.takes["layers.wk"] == ("split", 2)
    assert tp.takes["embed"] == ("split", 0)
    if tp.splits("ff_expert"):
        assert tp.takes["layers.we_gate"] == ("split", 3)
    elif tp.splits("experts"):
        assert tp.takes["layers.we_down"] == ("split", 1)


def test_plan_on_a_4_wide_model_axis(fake):
    """qwen2_vl's 12 / 2 heads on 4: 3 query heads a rank on one K / V head
    (a GQA group of 3); llama4's 40 / 8 on 4: 10 on 2, their own shards."""
    mesh = fake((4, 4))
    vl = _plan("qwen2_vl_2b", mesh)
    assert vl.range("heads", 12) == (0, 3) and vl.range("kv_heads", 2) == (0, 1)
    assert vl.takes["layers.bk"] == ("slice", 1, 0, 128)
    l4 = _plan("llama4_scout_17b_a16e", mesh)
    assert {p: l4.ranges[p] for p in ("heads", "kv_heads", "experts")} == {
        "heads": (0, 10), "kv_heads": (0, 2), "experts": (0, 4)}
    assert l4.takes["layers.wv"] == ("split", 2)


#: rank 0's ranges on 16 x 16 of the ssm, hybrid and audio families:
#: mamba2_370m's 32 SSM heads 2 a rank, its vocabulary (50,280) whole;
#: zamba2's 80 SSM heads 5 a rank, its shared block's 32 / 32 heads 2 a rank,
#: ff 640 and vocabulary 2,000 a rank; whisper's 20 heads whole, ff 320 a
#: rank, its vocabulary (51,866) whole
PLANS_16_MAMBA = {
    "mamba2_370m": {"ssm_heads": (0, 2)},
    "zamba2_2_7b": {"ssm_heads": (0, 5), "heads": (0, 2), "kv_heads": (0, 2), "ff": (0, 640),
                    "vocab": (0, 2000)},
    "whisper_large_v3": {"ff": (0, 320)},
}


def _mamba_takes(cfg, h0, h1):
    """How a rank with SSM heads ``h0:h1`` reads a layer's segmented leaves:
    its heads' ``z``, ``x`` and ``dt`` columns of ``in_proj`` and all of
    ``B`` / ``C``; its heads' ``x`` channels of the conv and all of ``B`` /
    ``C``; its heads of the per-head vectors."""
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    d = H * P
    proj = ((h0 * P, h1 * P), (d + h0 * P, d + h1 * P), (2 * d, 2 * d + 2 * N),
            (2 * d + 2 * N + h0, 2 * d + 2 * N + h1))
    conv = ((h0 * P, h1 * P), (d, d + 2 * N))
    return {"mamba.in_proj": ("pieces", 2, proj), "mamba.conv_w": ("pieces", 2, conv),
            "mamba.conv_b": ("pieces", 1, conv), "mamba.a_log": ("slice", 1, h0, h1),
            "mamba.d_skip": ("slice", 1, h0, h1), "mamba.dt_bias": ("slice", 1, h0, h1),
            "mamba.norm": ("split", 1), "mamba.out_proj": ("split", 1)}


@pytest.mark.parametrize("arch", list(PLANS_16_MAMBA))
@pytest.mark.parametrize("fsdp", [False, True])
def test_plan_of_the_ssm_hybrid_and_audio_families(fake, arch, fsdp):
    """What rank 0 of 16 x 16 computes a share of in the ssm, hybrid and
    audio families, fsdp or not, and how it reads each split leaf: a mamba
    layer's segmented leaves gathered and cut to its heads' columns, its
    norm and out_proj as they lie; zamba2's shared block as a transformer
    block; whisper's attention whole (20 heads on 16) but for its MLP."""
    tp = _plan(arch, fake((16, 16)), fsdp)
    assert dict(tp.ranges) == PLANS_16_MAMBA[arch]
    cfg = tconfigs.get_config(arch)
    if cfg.ssm_heads:
        want = _mamba_takes(cfg, *tp.ranges["ssm_heads"])
        assert {k: v for k, v in tp.takes.items() if k.startswith("mamba.")} == want
    if arch == "zamba2_2_7b":
        assert {k: tp.takes[f"shared_attn.{k}"] for k in ("wq", "wk", "wo", "w_up", "w_down")} == {
            "wq": ("split", 1), "wk": ("split", 1), "wo": ("split", 0), "w_up": ("split", 1),
            "w_down": ("split", 0)}
        assert tp.takes["embed"] == ("split", 0)
    if arch == "whisper_large_v3":
        assert sorted(tp.takes) == sorted(f"{s}.{w}" for s in ("enc", "dec")
                                          for w in ("w_gate", "w_up", "w_down"))
    assert "embed" not in tp.takes or arch == "zamba2_2_7b"


def test_mamba_heads_that_do_not_divide_stay_whole(fake):
    """Reduced mamba with 6 SSM heads on a 4-wide axis: the heads do not
    divide 4 (nor does in_proj's 230 columns, which the rules replicate), so
    no mamba leaf is cut and the layer is computed whole; the vocabulary
    (256) still splits."""
    cfg = dataclasses.replace(tconfigs.reduced_config("mamba2_370m"), ssm_heads=6)
    mesh = fake((4, 4))
    like = {k: torch.empty(v, device="meta") for k, v in param_shapes(cfg).items()}
    shardings = logical_to_sharding(param_axes(cfg), mesh, default_rules(mesh), like=like)
    assert shardings["mamba.in_proj"].tensor_dim("model") is None
    tp = model_axis(split_products(cfg), shardings)
    assert dict(tp.ranges) == {"vocab": (0, 64)}
    assert not any(k.startswith("mamba.") for k in tp.takes)


@pytest.mark.parametrize("arch", list(PLANS_16_MAMBA))
def test_dryrun_splits_the_ssm_hybrid_and_audio_families(fake, monkeypatch, arch):
    """The dry-run's train (remat full) and decode cells of the reduced
    configs on a 4 x 4 fake mesh, where the SSM heads, the shared block's
    and whisper's 4 heads, ``ff`` and the vocabulary split: each runs, and
    its per-device flops are the count from the shapes
    (``chip_smoke.shape_flops``, which the card's dryrun phase holds the
    16 x 16 cells to).  A decode cell's conv state is gathered and cut to a
    rank's channels, its SSM state kept as the rank's heads; the state the
    step returns is in the rules' blocks again, each leaf the shape of the
    block it came in."""
    import chip_smoke
    from repro_torch.configs import ShapeCell
    from repro_torch.launch import dryrun

    monkeypatch.setattr(dryrun, "get_config", tconfigs.reduced_config)
    mesh = fake((4, 4))
    cfg = tconfigs.reduced_config(arch)
    for kind in ("train", "decode"):
        seq = 1600 if arch.startswith("whisper") and kind == "train" else 64
        cell = ShapeCell("c", seq, 16, kind)
        rec = dryrun.run_cell(arch, cell, mesh, "4x4", remat="full")
        assert rec["status"] == "ok", rec.get("error")
        assert rec["flops"] == chip_smoke.shape_flops(cfg, kind, seq, 16, data=4, model=4)
    if cfg.ssm_heads:
        assert rec["placements"]["state"]["conv"] == [None, "data", None, "model"]
    step, args, shardings = dryrun.build_cell(arch, cell, mesh, remat="full")
    local = [dryrun._localize(a, s) for a, s in zip(args, shardings)]
    _, state = step(*local)

    def shapes(tree):
        return {k: [tuple(t.shape) for t in (v if isinstance(v, tuple) else (v,))]
                for k, v in tree.items()}

    assert shapes(state) == shapes(local[2])


@pytest.mark.parametrize("shape", [(2, 70, 4, 8, 16, 32), (1, 64, 2, 16, 8, 16)])
@pytest.mark.parametrize("backward", [False, True])
def test_ssd_flops_closed_form_counts_the_scan(shape, backward):
    """``chip_smoke.ssd_flops`` (forward; 3 times that with backward) and
    ``ssd_decode_flops`` from the shapes alone are what ``FlopCounterMode``
    counts for ``mamba2.ssd_chunked`` and a decode step's conv and
    ``ssd_decode_step`` on meta tensors: the scan does neither more nor
    less work than the dry-run's figures are held to."""
    import chip_smoke
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.models import mamba2

    B, S, H, P, N, chunk = shape

    def t(*dims):
        return torch.empty(dims, device="meta", requires_grad=backward)

    x, dt, a, bm, cm = t(B, S, H, P), t(B, S, H), t(H), t(B, S, 1, N), t(B, S, 1, N)
    with FlopCounterMode(display=False) as counter:
        y, _ = mamba2.ssd_chunked(x, dt, a, bm, cm, chunk=chunk)
        if backward:
            torch.autograd.grad(y.sum(), (x, dt, a, bm, cm))
    fwd = chip_smoke.ssd_flops(B, S, H, P, N, chunk)
    assert counter.get_total_flops() == (3 * fwd if backward else fwd)

    conv = H * P + 2 * N
    with FlopCounterMode(display=False) as counter:
        torch.einsum("bkc,kc->bc", t(B, mamba2.D_CONV, conv), t(mamba2.D_CONV, conv))
        mamba2.ssd_decode_step(t(B, H, P), t(B, H), t(H), t(B, N), t(B, N), t(B, H, P, N))
    assert counter.get_total_flops() == chip_smoke.ssd_decode_flops(B, H, P, N, conv,
                                                                    mamba2.D_CONV)


def test_gather_keeps_each_cut_head_once(fake):
    """``ModelAxis.gather`` along a dim: the ranks' blocks in rank order, and
    a K / V head that several ranks read (2 heads on a 4-wide axis, one a
    rank) once, so that a decode cache gathers back to its heads."""
    mesh = fake((4, 4))
    tp = ModelAxis(mesh.get_group("model"), {"kv_heads": (0, 1), "ssm_heads": (0, 2)})
    kv = torch.empty((2, 3, 1, 5), device="meta")
    assert tp.gather(kv, "kv_heads", 2, units=2).shape == (2, 3, 2, 5)
    assert tp.gather(kv, "kv_heads", 2).shape == (2, 3, 4, 5)
    ssm = torch.empty((1, 2, 2, 4, 8), device="meta")
    assert tp.gather(ssm, "ssm_heads", 2, units=8).shape == (1, 2, 8, 4, 8)
    assert tp.gather(ssm, "heads", 2) is ssm


@pytest.mark.parametrize("units, want", [
    ((0, 1), (("pieces", 1, ((0, 2), (6, 8), (12, 15), (15, 16))))),
    ((1, 3), (("pieces", 1, ((2, 6), (8, 12), (12, 15), (16, 18))))),
])
def test_segmented_take_cuts_each_segment(units, want):
    """A dim of segments ``z | x | BC | dt`` (2, 2 a unit of 3; 3 whole; 1
    a unit): a rank's units' columns of each split segment, the whole one
    entire, in order."""
    seg = Segments(1, ((2, True), (2, True), (3, False), (1, True)))
    assert seg.take(units, 3) == want
    full = torch.arange(18.0)[None]
    cols = torch.cat([full[:, a:b] for a, b in want[2]], dim=1)
    assert cols.shape[1] == 4 * (units[1] - units[0]) + 3 + (units[1] - units[0])


def test_nothing_split_on_a_one_wide_model_axis(fake):
    """A model axis of 1 splits nothing and issues no collective."""
    assert _plan("stablelm_3b", fake((2, 1))) is WHOLE


@pytest.mark.parametrize("units, group, want", [
    ((0, 2), 1, (0, 2)), ((4, 8), 2, (2, 4)),      # whole groups
    ((3, 6), 6, (0, 1)), ((6, 9), 6, (1, 2)),      # within one group
    ((2, 4), 3, None), ((0, 4), 6, None),          # neither: the heads stay whole
])
def test_read_range(units, group, want):
    """The K / V heads a rank's query heads read (GQA group ``group``)."""
    assert read_range(units, group) == want


# ---------------------------------------------------------------------------
# On ranks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def on_ranks(tmp_path_factory):
    """Both spawns' records (2 ranks, then 4), keyed by name."""
    out = _spawn(ranks.tp_two_ranks, 2, tmp_path_factory.mktemp("tp_two"), deadline_s=300)
    out.update(_spawn(ranks.tp_four_ranks, 4, tmp_path_factory.mktemp("tp_four"),
                      deadline_s=300))
    return out


@pytest.fixture(scope="module")
def unmeshed(tmp_path_factory):
    """The port without a mesh, per config: the trainer's gradients, losses,
    norms and parameters, the forward's flops by leaf, and the served
    logits and tokens."""
    out = {}
    for name in CONFIGS:
        cfg = ranks.tp_config(name)
        grads, losses, norms, params = ranks.tp_train(
            cfg, None, str(tmp_path_factory.mktemp(f"tp_{name}")))
        out[name] = {"grads": {k: v for k, v in grads.items()}, "losses": losses,
                     "norms": norms, "params": {k: v.detach().numpy() for k, v in params.items()},
                     "flops": ranks.tp_flops(cfg)[0]}
        for impl in ranks.TP_IMPLS:
            out[name][impl] = ranks.tp_serve(cfg, impl)
        out[name]["bf16"] = ranks.tp_serve(cfg, "chunked", cache=torch.bfloat16)
    out["tie"] = ranks.tp_serve(ranks.tp_config("stablelm"), "chunked", tie=True)
    return out


@pytest.fixture(scope="module")
def reference_losses():
    """The reference's un-meshed step (``value_and_grad`` of its
    ``train_loss``, then its ``adamw_update``) from the port's initial
    weights on the same batches, per config."""
    out = {}
    ocfg = JAdamWConfig(**dataclasses.asdict(ranks.OPT))
    for name in CONFIGS:
        arch, change = ranks.TP_CONFIGS[name]
        cfg = ranks.tp_config(name)
        init = Model(cfg, device="cpu").init(seed=0)
        params = jax.tree.map(jnp.asarray, convert.params_to_reference(
            {k: p.detach() for k, p in init.named_parameters()}))
        jcfg = dataclasses.replace(change(jconfigs.reduced_config(arch)), dtype=jnp.float32)
        jmodel = JModel(jcfg, attn_impl="chunked")
        data = ranks.tp_data(cfg)
        pipe = JSyntheticLM(JDataConfig(vocab=data.vocab, seq_len=data.seq_len,
                                        global_batch=data.global_batch, seed=data.seed))
        step = jax.jit(jax.value_and_grad(jmodel.train_loss))
        opt, losses = jadamw_init(params), []
        for i in range(ranks.STEPS):
            batch = {**pipe.batch(i), **ranks.model_inputs(
                cfg, data.global_batch, data.seq_len, 8, i)}
            loss, grads = step(params, {k: jnp.asarray(v) for k, v in batch.items()})
            params, opt, _ = jadamw_update(ocfg, params, grads, opt)
            losses.append(float(loss))
        out[name] = np.array(losses)
    return out


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("mesh", MESHES)
def test_train_on_ranks_matches_unmeshed_and_reference(on_ranks, unmeshed, reference_losses,
                                                        mesh, name):
    """float32: the first batch's gradient of every leaf, and after 3 steps
    the losses, the global gradient norms (the replica count of
    ``_mesh_norm``) and every parameter within 1e-5 of the port's trainer
    without a mesh, but for the elements whose first gradient is rounding
    noise (``test_torch_launch.rounding_noise``); the losses within 1e-5 of
    the reference's step."""
    got, want = on_ranks[f"train_{mesh}_{name}"], unmeshed[name]
    _close({k[2:]: v for k, v in got.items() if k.startswith("g.")}, want["grads"])
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["norms"], want["norms"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["losses"], reference_losses[name], rtol=1e-5, atol=1e-5)
    _close(_params(got), want["params"], skip=rounding_noise(want["grads"]))


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("impl", ranks.TP_IMPLS)
@pytest.mark.parametrize("mesh", SERVED)
def test_serving_on_ranks_matches_unmeshed(on_ranks, unmeshed, mesh, impl, name):
    """Prefill of 2 x 136 tokens (the MoE capacity path: 272 > 256; 9 SSD
    chunks of 16, so a rank's scan carries its state across chunks;
    whisper: its frames, then a start token), then 4 greedy decode steps
    from each rank's cache of its K / V heads and states of its SSM heads
    and conv channels: the whole logits of every step within 1e-5, the
    greedy tokens equal.  The caches and conv states are float32 here: a
    bfloat16 one rounds a value an ulp apart wherever the ranks' summed
    parts differ from the unsplit product in its last bit."""
    got = on_ranks[f"serve_{mesh}_{name}_{impl}"]
    logits, tokens = unmeshed[name][impl]
    assert got["logits"].shape == logits.shape
    np.testing.assert_allclose(got["logits"], logits, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got["tokens"], tokens)
    np.testing.assert_array_equal(tokens, logits.argmax(-1))


#: about three times the largest logit gap these runs show with bfloat16
#: caches (6.8e-5, llama4 on 2 ranks; with bfloat16 conv states 3.3e-5,
#: zamba2 on 2 ranks)
BF16_CACHE_TOL = 2e-4


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("mesh", SERVED)
def test_serving_on_ranks_with_bfloat16_caches(on_ranks, unmeshed, mesh, name):
    """The same prefill and greedy steps (``chunked``) with the bfloat16 KV
    caches and mamba conv states the port serves with (whisper keeps its
    caches in ``cfg.dtype``): a value the ranks' summed parts put an ulp off
    the unsplit product's rounds to another bfloat16 now and then, so the
    logits are held at :data:`BF16_CACHE_TOL` and the greedy tokens are
    equal."""
    got = on_ranks[f"serve_{mesh}_{name}_bf16"]
    logits, tokens = unmeshed[name]["bf16"]
    np.testing.assert_allclose(got["logits"], logits, rtol=BF16_CACHE_TOL, atol=BF16_CACHE_TOL)
    np.testing.assert_array_equal(got["tokens"], tokens)


@pytest.mark.parametrize("mesh", SERVED)
def test_greedy_tie_across_vocabulary_blocks_takes_the_lowest_index(on_ranks, unmeshed, mesh):
    """The head's four vocabulary blocks made equal: the largest logit is
    tied in every rank's block, and the greedy token is the first block's,
    as ``argmax`` of the whole logits picks it."""
    got = on_ranks[f"serve_{mesh}_tie"]
    logits, tokens = unmeshed["tie"]
    V = ranks.tp_config("stablelm").vocab
    np.testing.assert_array_equal(logits[..., :V // 4], logits[..., V // 4:V // 2])
    assert (tokens < V // 4).all()
    np.testing.assert_array_equal(got["tokens"], tokens)
    np.testing.assert_allclose(got["logits"], logits, rtol=1e-5, atol=1e-5)


def _rank_share(cfg, leaf, M):
    """The part of the un-meshed forward's matrix-product flops of ``leaf``
    a rank computes on an ``M``-wide model axis: a ``M``-th of each split
    product (query heads where ``n_heads`` divides ``M``, and their own K /
    V heads where ``n_kv_heads`` does, else one K / V head; every MLP, the
    experts; the vocabulary where it divides ``M``); of mamba's ``in_proj``
    the ``z``, ``x`` and ``dt`` columns' ``M``-th and the ``B`` / ``C``
    columns whole; the rest whole (the router, the gates, ``patch_proj``,
    ``frame_proj``)."""
    one, part = Fraction(1), Fraction(1, M)
    name = leaf.rsplit(".", 1)[-1]
    if leaf in ("embed", "lm_head"):
        return one if cfg.vocab % M else part
    if leaf == "mamba.in_proj":
        H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
        return Fraction((2 * H * P + H) // M + 2 * N, 2 * H * P + 2 * N + H)
    if leaf == "mamba.out_proj":
        return part
    if name in ("wq", "wo", "bq", "xq", "xo"):
        return part if cfg.n_heads % M == 0 else one
    if name in ("wk", "wv", "bk", "bv", "xk", "xv"):
        if cfg.n_heads % M:
            return one
        return part if cfg.n_kv_heads % M == 0 else Fraction(1, cfg.n_kv_heads)
    if name.startswith(("w_", "we_")) or name in ("ws_gate", "ws_up", "ws_down"):
        return part
    return one


def _model_gathers(cfg, M):
    """The operand shapes of the all-gathers over ``model`` of one forward,
    by the leaves they gather: a mamba layer's ``in_proj``, ``conv_w`` and
    ``conv_b``, whose ``B`` / ``C`` columns every rank reads whole (each
    where the rules shard it over ``model``); the K / V projections where a
    rank's K / V head is cut across the storage shards (``n_kv_heads`` does
    not divide the axis); and whisper's attention weights where its heads
    do not divide the axis, so that it computes whole heads."""
    D, L = cfg.d_model, cfg.n_layers
    named = []
    if cfg.ssm_heads:
        H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
        proj, conv = 2 * H * P + 2 * N + H, H * P + 2 * N
        if proj % M == 0:
            named += [("mamba.in_proj", [proj // M, D])] * L
        if conv % M == 0:
            named += [("mamba.conv_w", [conv // M, 4]), ("mamba.conv_b", [conv // M])] * L
    cols = cfg.n_kv_heads * cfg.dh // M
    if cfg.family == "audio" and cfg.n_heads % M:
        named += [(f"{s}.{w}", [cfg.n_heads * cfg.dh // M, D]) for s, ws in (
            ("enc", ("wq", "wk", "wv", "wo")),
            ("dec", ("wq", "wk", "wv", "wo", "xq", "xk", "xv", "xo"))) for w in ws] * L
    elif cfg.n_heads and cfg.n_kv_heads % M:
        named += [("layers.wk", [cols, D]), ("layers.wv", [cols, D])] * L
        if cfg.qkv_bias:
            named += [("layers.bk", [cols]), ("layers.bv", [cols])] * L
    return sorted(shape for _, shape in named)


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("mesh", SERVED)
def test_each_rank_computes_its_share(on_ranks, unmeshed, mesh, name):
    """One forward of ``train_loss`` on every rank: the matrix-product flops
    of each leaf are :func:`_rank_share` of the un-meshed forward's (a copy
    gathered from a leaf counts as the leaf's); the only all-gathers over
    ``model`` are :func:`_model_gathers`."""
    cfg = ranks.tp_config(name)
    M = int(mesh.rsplit("model", 1)[1])
    whole = unmeshed[name]["flops"]
    for rec in json.loads(str(on_ranks[f"flops_{mesh}_{name}"]["ranks"])):
        flops = rec["flops"]
        assert flops["total"] == flops["counter"]       # every product is counted
        for leaf in set(whole) - {"total", "counter"}:
            assert flops.get(leaf, 0) == whole[leaf] * _rank_share(cfg, leaf, M), leaf
        gathers = sorted(shape for op, group, shape in rec["collectives"]
                         if op == "all_gather_into_tensor" and group == rec["model_group"])
        assert gathers == _model_gathers(cfg, M)


@pytest.mark.parametrize("mesh", SERVED)
def test_all_sum_sums_forward_and_backward(on_ranks, mesh):
    """``ModelAxis.all_sum`` (the gated norm's sum of squares): every rank
    reads the sum of the ranks' parts, and each part's gradient is the sum
    of every rank's gradient of the sum (rank ``r`` weighs it by ``r + 1``)."""
    got = on_ranks[f"all_sum_{mesh}"]
    M = int(mesh.rsplit("model", 1)[1])
    np.testing.assert_array_equal(got["sum"], np.tile(got["parts"].sum(0), (M, 1)))
    np.testing.assert_array_equal(got["grad"], np.full_like(got["parts"], M * (M + 1) / 2))
