"""Tensor- and expert-parallel products on the ``model`` axis, on the CPU.

* the plan (``repro_torch.sharding.model_axis`` of
  ``repro_torch.models.split_products``) of every transformer family on the
  production meshes: which products are split and this rank's ranges
  (heads, K / V heads, ``ff``, experts or ``ff_expert``, vocabulary);
  nothing split for the ssm, hybrid and audio families;
* the meshed trainer on ``gloo`` ranks (``tests/torch_mesh_ranks.py``, which
  imports no JAX) on ``(data=1, model=2)``, ``(1, 4)`` and ``(2, 2)``, float32,
  for seven reduced configs (dense, a cut K / V head, the vision prefix, MoE
  with clean expert parallelism and with ``ff_expert``, llama4, a vocabulary
  4 does not divide): the first batch's gradients, 3 steps' losses, gradient
  norms and parameters against the port's un-meshed trainer, the losses
  against the reference's un-meshed step;
* serving on ranks: prefill then 4 greedy decode steps, ``attn_impl`` ``xla``
  and ``chunked``, logits and tokens against the un-meshed port, a logit
  tied across the ranks' vocabulary blocks resolved to the lowest index;
* the work is split: each rank's matrix-product flops by leaf against the
  un-meshed forward's, and the all-gathers it issues over ``model``.
"""

import dataclasses
import json

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
from repro_torch.sharding import WHOLE, default_rules, logical_to_sharding, model_axis, read_range
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


@pytest.mark.parametrize("arch", ["mamba2_370m", "zamba2_2_7b", "whisper_large_v3"])
def test_nothing_split_outside_the_transformer_families(fake, arch):
    """The ssm, hybrid and audio families gather every leaf (ROADMAP)."""
    assert _plan(arch, fake((16, 16))) is WHOLE


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
            batch = {**pipe.batch(i), **ranks.vision_inputs(
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
    """Prefill of 2 x 136 tokens (the MoE capacity path: 272 > 256), then 4
    greedy decode steps from each rank's cache of its K / V heads: the whole
    logits of every step within 1e-5, the greedy tokens equal.  The caches
    are float32 here: a bfloat16 cache rounds a key an ulp apart wherever
    the ranks' summed parts differ from the unsplit product in its last bit."""
    got = on_ranks[f"serve_{mesh}_{name}_{impl}"]
    logits, tokens = unmeshed[name][impl]
    assert got["logits"].shape == logits.shape
    np.testing.assert_allclose(got["logits"], logits, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got["tokens"], tokens)
    np.testing.assert_array_equal(tokens, logits.argmax(-1))


#: about three times the largest logit gap these runs show with bfloat16
#: caches (6.8e-5, llama4 on 2 ranks)
BF16_CACHE_TOL = 2e-4


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("mesh", SERVED)
def test_serving_on_ranks_with_bfloat16_caches(on_ranks, unmeshed, mesh, name):
    """The same prefill and greedy steps (``chunked``) with the bfloat16 KV
    caches the port serves with: a key the ranks' summed parts put an ulp
    off the unsplit product's rounds to another bfloat16 now and then, so
    the logits are held at :data:`BF16_CACHE_TOL` and the greedy tokens are
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


#: the leaves whose products the plan splits in every one of these configs
#: but for the vocabulary of ``vocab250`` on 4 ranks, which 4 does not divide
SPLIT = ("layers.w_gate", "layers.w_up", "layers.w_down", "layers.we_gate", "layers.we_up",
         "layers.we_down", "layers.ws_gate", "layers.ws_up", "layers.ws_down", "layers.wq",
         "layers.wo", "lm_head", "embed")


def _model_gathers(cfg, M):
    """The operand shapes of the all-gathers over ``model`` of one forward:
    the K / V projections, where a rank's K / V head is cut across the
    storage shards (``n_kv_heads`` does not divide the axis)."""
    if cfg.n_kv_heads % M == 0:
        return []
    cols = cfg.n_kv_heads * cfg.dh // M
    one = [[cols, cfg.d_model]] * 2 + ([[cols]] * 2 if cfg.qkv_bias else [])
    return sorted(one * cfg.n_layers)


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("mesh", SERVED)
def test_each_rank_computes_its_share(on_ranks, unmeshed, mesh, name):
    """One forward of ``train_loss`` on every rank: the matrix-product flops
    of each split leaf are the un-meshed forward's over the model axis, the
    rest whole; the only all-gathers over ``model`` are the cut K / V
    heads'."""
    cfg = ranks.tp_config(name)
    M = int(mesh.rsplit("model", 1)[1])
    whole = unmeshed[name]["flops"]
    for rec in json.loads(str(on_ranks[f"flops_{mesh}_{name}"]["ranks"])):
        flops = rec["flops"]
        assert flops["total"] == flops["counter"]       # every product is counted
        for leaf in SPLIT:
            if leaf in whole:
                share = 1 if leaf in ("lm_head", "embed") and cfg.vocab % M else M
                assert flops[leaf] * share == whole[leaf], leaf
        if cfg.n_kv_heads % M == 0:    # else a cut head's columns, gathered: not a leaf's storage
            for leaf in ("layers.wk", "layers.wv"):
                assert flops[leaf] * M == whole[leaf], leaf
        for leaf in set(whole) - set(SPLIT) - {"layers.wk", "layers.wv", "total", "counter"}:
            assert flops[leaf] == whole[leaf], leaf    # the router, gates, patch_proj
        gathers = sorted(shape for op, group, shape in rec["collectives"]
                         if op == "all_gather_into_tensor" and group == rec["model_group"])
        assert gathers == _model_gathers(cfg, M)
