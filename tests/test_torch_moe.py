"""The port's mixture-of-experts family against the JAX package, on the CPU.

``moe_ffn`` (both paths, with drops, with tied router columns), the MoE
models' forward, prefill and decode, and ``Server.serve`` on reduced
qwen2_moe_a2_7b and llama4_scout_17b_a16e; their configs, parameter counts and
init layout; and the memory rules of full width: ``Model.init`` draws in
place block by block, and ``Server`` adopts a state dict without a model of
its own.  Inputs and weights are made with numpy from a seed and handed to
both sides.  Tolerances: float32 2e-5 per module, 1e-4 at model level;
bfloat16 5e-2.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.models import transformer as jtransformer
from repro.runtime.serving import Request as JRequest
from repro_torch import convert
from repro_torch.models import Model, common, transformer
from repro_torch.runtime import Request, ServeConfig, Server
from test_torch_models import JDT, _both, _close, _configs, _np, _tokens, _weights
from test_torch_serving import _compare_runs, _record, _servers

torch.set_num_threads(1)

MOE = ["qwen2_moe_a2_7b", "llama4_scout_17b_a16e"]
NEW = MOE + ["qwen2_vl_2b"]


def _layer(arch, dtype=torch.float32, seed=0, **moe_kw):
    """Layer 0's parameters of the reduced ``arch`` on both sides, and the
    MoE config (``moe_kw`` changes it)."""
    tcfg, jcfg = _configs(arch, dtype)
    m = dataclasses.replace(tcfg.moe, **moe_kw)
    tree = _weights(tcfg, seed)
    tlp = {k: torch.from_numpy(v[0]).to(dtype) for k, v in tree["layers"].items()}
    jlp = {k: jnp.asarray(v[0]).astype(jcfg.dtype) for k, v in tree["layers"].items()}
    return tlp, jlp, m


def _x(T, D, dtype=torch.float32, seed=3):
    x = (np.random.default_rng(seed).standard_normal((T, D)) * 0.5).astype(np.float32)
    return torch.from_numpy(x).to(dtype), jnp.asarray(x).astype(JDT[dtype])


def _drops(expert, E, C):
    """How many assignments find their expert full (the capacity path's rule)."""
    counts = np.bincount(_np(expert).astype(np.int64).reshape(-1), minlength=E)
    return int(np.maximum(counts - C, 0).sum())


# ---------------------------------------------------------------------------
# moe_ffn
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("dense_max", [0, 1024])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_ffn_matches_reference(arch, dense_max, dtype):
    """Both paths (capacity: ``dense_path_max_tokens=0``; exact: 1024) of both
    reduced MoE configs: qwen2_moe (8 experts top-2, a gated shared expert,
    normalised gates) and llama4 (4 experts top-1, an ungated shared one)."""
    tlp, jlp, m = _layer(arch, dtype)
    x, jx = _x(40, tlp["router"].shape[0], dtype)
    got = transformer.moe_ffn(x, tlp, m, dense_path_max_tokens=dense_max)
    want = jtransformer.moe_ffn(jx, jlp, m, dense_path_max_tokens=dense_max)
    assert got.shape == (40, x.shape[1]) and got.dtype == dtype
    _close(got, want, 2e-5 if dtype == torch.float32 else 5e-2)


@pytest.mark.parametrize("arch", MOE)
def test_moe_ffn_with_drops_matches_reference(arch):
    """300 tokens at the default capacity factor: experts overflow and the
    dropped assignments contribute nothing, in both frameworks alike."""
    tlp, jlp, m = _layer(arch)
    # every token shares one direction, so that the router favours some experts
    D = tlp["router"].shape[0]
    x, _ = _x(300, D)
    x = x + torch.from_numpy(np.random.default_rng(9).standard_normal(D).astype(np.float32))
    jx = jnp.asarray(x.numpy())
    C = max(1, int(math.ceil(300 * m.top_k / m.n_experts * m.capacity_factor)))
    _, expert = transformer.route(x, tlp, m)
    assert _drops(expert, m.n_experts, C) > 0, "the case must drop assignments"
    got = transformer.moe_ffn(x, tlp, m)
    want = jtransformer.moe_ffn(jx, jlp, m)
    _close(got, want, 2e-5)
    # the drops change the result: the exact path differs
    exact = transformer.moe_ffn(x, tlp, m, dense_path_max_tokens=1024)
    assert float((got - exact).abs().max()) > 1e-3


@pytest.mark.parametrize("dense_max", [0, 1024])
@pytest.mark.parametrize("tie", ["all", "pairs"])
def test_router_ties_pick_the_reference_experts(dense_max, tie):
    """Tied router columns, top-3 of 8 experts: among equal probabilities the
    lower expert index comes first, as ``jax.lax.top_k`` orders them.  "all":
    a zero router, so every token routes to experts 0, 1, 2 in that order;
    "pairs": columns 2i and 2i+1 equal, so the best pair fills two places and
    the third falls inside the next pair, a tie in every row."""
    tlp, jlp, m = _layer("qwen2_moe_a2_7b", capacity_factor=1.0, top_k=3)
    router = tlp["router"].clone()
    if tie == "all":
        router.zero_()
    else:
        router[:, 1::2] = router[:, 0::2]
    tlp["router"], jlp["router"] = router, jnp.asarray(router.numpy())
    x, jx = _x(300, router.shape[0])
    gate, expert = transformer.route(x, tlp, m)
    jprobs = jax.nn.softmax((jx @ jlp["router"]).astype(jnp.float32), axis=-1)
    jgate, jexpert = jax.lax.top_k(jprobs, m.top_k)
    assert np.array_equal(expert.numpy(), np.asarray(jexpert))
    if tie == "all":
        assert expert.tolist() == [[0, 1, 2]] * 300
    else:
        probs = torch.softmax((x @ router).float(), dim=-1)
        assert torch.equal(probs[:, 0::2], probs[:, 1::2]), "the columns must tie exactly"
        assert bool((expert[:, 0] % 2 == 0).all()) and torch.equal(expert[:, 1], expert[:, 0] + 1)
        assert bool((expert[:, 2] % 2 == 0).all())
    _close(gate, jgate / jnp.sum(jgate, axis=-1, keepdims=True), 2e-6)
    C = max(1, int(math.ceil(300 * m.top_k / m.n_experts * m.capacity_factor)))
    assert _drops(expert, m.n_experts, C) > 0
    _close(transformer.moe_ffn(x, tlp, m, dense_path_max_tokens=dense_max),
           jtransformer.moe_ffn(jx, jlp, m, dense_path_max_tokens=dense_max), 2e-5)


def test_moe_capacity_matches_dense_when_no_drop():
    """The counterpart of the reference's test: with room for every
    assignment the capacity path is the exact path."""
    tcfg = dataclasses.replace(tconfigs.reduced_config("qwen2_moe_a2_7b"), dtype=torch.float32)
    m = dataclasses.replace(tcfg.moe, capacity_factor=8.0)
    model = Model(dataclasses.replace(tcfg, moe=m), attn_impl="xla", device="cpu").init(seed=0)
    lp = {k: w[0] for k, w in model.params["layers"].items()}
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((300, tcfg.d_model))
                         .astype(np.float32))
    y_cap = transformer.moe_ffn(x, lp, m, dense_path_max_tokens=0)
    y_dense = transformer.moe_ffn(x, lp, m, dense_path_max_tokens=1024)
    _close(y_cap, y_dense, 1e-5)


def test_moe_path_threshold_is_the_references():
    """256 tokens take the exact path, 257 the capacity path (decode at 8
    slots always the exact one)."""
    tlp, _, m = _layer("qwen2_moe_a2_7b")
    assert transformer.DENSE_PATH_MAX_TOKENS == 256
    for T, path_max in ((8, 1024), (256, 1024), (257, 0)):
        x, _ = _x(T, tlp["router"].shape[0])
        assert torch.equal(transformer.moe_ffn(x, tlp, m),
                           transformer.moe_ffn(x, tlp, m, dense_path_max_tokens=path_max)), T


@pytest.mark.parametrize("dense_max", [0, 1024])
def test_moe_ffn_reads_nothing_back(dense_max):
    """On meta tensors, which hold no values, a host read (``.item()``,
    ``.tolist()``, a boolean mask) would raise: both paths run through, and
    their shapes depend on ``T`` alone."""
    tlp, _, m = _layer("qwen2_moe_a2_7b")
    meta = {k: v.to("meta") for k, v in tlp.items()}
    x = torch.empty((300, tlp["router"].shape[0]), device="meta")
    y = transformer.moe_ffn(x, meta, m, dense_path_max_tokens=dense_max)
    assert y.device.type == "meta" and y.shape == x.shape


# ---------------------------------------------------------------------------
# models: forward, prefill, decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("impl", ["xla", "chunked", "hopper"])
def test_forward_matches_reference(arch, impl):
    """Two prompts of 24 tokens (48 tokens: the exact path), then one of 300
    (the capacity path; in reduced llama4 it crosses nine 32-token attention
    chunks); ``impl="hopper"`` on CPU tensors runs the kernel's plain version."""
    model, jmodel, jparams = _both(arch, attn_impl=impl)
    j_impl = "xla" if impl == "xla" else "chunked"
    for B, S in ((2, 24), (1, 300)):
        toks = _tokens(model.cfg, B, S)
        want, _ = jtransformer.forward(jmodel.cfg, jparams, jnp.asarray(toks), attn_impl=j_impl)
        got, caches = transformer.forward(model.cfg, model.params, torch.from_numpy(toks),
                                          attn_impl=impl)
        assert caches is None and got.shape == (B, S, model.cfg.d_model)
        _close(got, want, 1e-4)


@pytest.mark.parametrize("arch", MOE)
def test_blocks_bfloat16_match_reference(arch):
    """bfloat16, one block at a time, each fed the reference's own input to
    that layer (so that no difference carries from layer to layer).  The two
    frameworks round the router's input differently, so a token whose top-k
    boundary is a near tie may take another expert on either side (the
    reference's bf16 run parts from its fp32 run at such tokens too).  The
    router's logits are bf16 products, spaced about 2e-3 at this width, which
    moves a probability of 1/8 by about 5e-4: every token whose margin at the
    top-k boundary is above ten times that, 5e-3, agrees within 5e-2, and such
    tokens are at least three in four."""
    model, jmodel, jparams = _both(arch, dtype=torch.bfloat16)
    cfg, jcfg = model.cfg, jmodel.cfg
    toks = _tokens(cfg, 2, 16)
    pos = np.broadcast_to(np.arange(16, dtype=np.int32)[None], (2, 16)).copy()
    jh = jparams["embed"][jnp.asarray(toks)].astype(jcfg.dtype)
    margins = []
    route = transformer.route

    def recorded(x, lp, m):
        probs = torch.sort(torch.softmax((x @ lp["router"]).float(), -1), -1, descending=True)[0]
        margins.append((probs[:, m.top_k - 1] - probs[:, m.top_k]).reshape(2, 16))
        return route(x, lp, m)

    compared = 0
    for i, kind in enumerate(cfg.layer_kinds()):
        lp = {k: w[i] for k, w in model.params["layers"].items()}
        jlp = {k: w[i] for k, w in jparams["layers"].items()}
        want, _ = jtransformer.block(jcfg, jh, jlp, jnp.asarray(kind), jnp.asarray(pos), "chunked")
        transformer.route = recorded
        try:
            got = transformer.block(cfg, torch.from_numpy(_np(jh).copy()).bfloat16(), lp, kind,
                                    torch.from_numpy(pos), "chunked")
        finally:
            transformer.route = route
        assert got.dtype == torch.bfloat16
        clear = (margins[-1] > 5e-3).numpy()
        assert clear.mean() >= 0.75, f"layer {i}: {clear.mean():.2f} of the tokens route clearly"
        _close(_np(got)[clear], _np(want)[clear], 5e-2)
        compared += int(clear.sum())
        jh = want
    assert compared >= 0.75 * 32 * cfg.n_layers
    # the head on the last layer's output, in bf16
    h = common.rms_norm(torch.from_numpy(_np(jh).copy()).bfloat16(), model.params["final_ln"])
    jfinal = jtransformer.rms_norm(jh, jparams["final_ln"])
    _close(model.logits(h), jmodel.logits(jparams, jfinal), 5e-2)


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("impl", ["chunked", "hopper"])
@pytest.mark.parametrize("S", [8, 300])
def test_prefill_decode_logits_match_reference(arch, impl, S):
    """Prefill (``S`` = 300: the capacity path) and one decode step, on each
    side's own cache and on the reference's state carried across; the head
    is ``lm_head`` (both configs are untied).  Each side attends over its
    own bfloat16 cache, whose roundings of keys that agree to 1e-6 may part
    by an ulp: over 300 tokens some do, so that prefill is held within the
    cache's rounding (2e-2, as the decode step on its own cache) and the
    carried state to 1e-4; the 300-token forward without a cache is held to
    1e-4 by ``test_forward_matches_reference``."""
    model, jmodel, jparams = _both(arch, attn_impl=impl)
    cfg = model.cfg
    assert not cfg.tie_embeddings and "lm_head" in model.state_dict()
    B = 2 if S == 8 else 1
    toks = _tokens(cfg, B, S + 1)
    max_len = S + 8
    jh, jstate = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks[:, :S])}, max_len)
    h, state = model.prefill({"tokens": torch.from_numpy(toks[:, :S])}, max_len)
    tol = 1e-4 if S == 8 else 2e-2
    _close(h, jh, tol)
    _close(model.logits(h[:, -1:]), jmodel.logits(jparams, jh[:, -1:]), tol)
    assert state["pos"].tolist() == np.asarray(jstate["pos"]).tolist() == [S] * B
    for got, want in zip(state["kv"], jstate["kv"]):
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        _close(got, want, 2e-2)
    jh2, jstate2 = jmodel.decode_step(jparams, jnp.asarray(toks[:, S:]), jstate)
    h2, state2 = model.decode_step(torch.from_numpy(toks[:, S:]), state)
    assert state2["pos"].tolist() == [S + 1] * B
    _close(h2, jh2, 2e-2)
    carried = convert.state_from_reference(
        {"kv": tuple(_np(x) for x in jstate["kv"]), "pos": np.asarray(jstate["pos"])},
        device="cpu")
    h3, state3 = model.decode_step(torch.from_numpy(toks[:, S:]), carried)
    _close(h3, jh2, 1e-4)
    _close(model.logits(h3), jmodel.logits(jparams, jh2), 1e-4)
    for got, want in zip(convert.state_to_reference(state3)["kv"], jstate2["kv"]):
        _close(got, want, 2e-2)


def test_llama4_layers_chunk_and_skip_rope_as_the_reference():
    """Reduced llama4: three chunked RoPE layers and one global NoPE layer."""
    cfg, jcfg = _configs("llama4_scout_17b_a16e")
    assert list(cfg.layer_kinds()) == np.asarray(jcfg.layer_kinds()).tolist() == [0, 0, 0, 1]
    assert transformer._mask_params(cfg, 0) == (transformer.BIG, 32)
    assert transformer._mask_params(cfg, 1) == (transformer.BIG, transformer.BIG)
    x = np.random.default_rng(0).standard_normal((1, 6, 2, 16)).astype(np.float32)
    pos = np.arange(6, dtype=np.int32)[None]
    for kind in (0, 1):
        got = transformer._rope(cfg, torch.from_numpy(x), torch.from_numpy(pos), kind)
        want = jtransformer._rope(jcfg, jnp.asarray(x), jnp.asarray(pos), jnp.asarray(kind))
        _close(got, want, 2e-5)
    assert torch.equal(transformer._rope(cfg, torch.from_numpy(x), torch.from_numpy(pos), 1),
                       torch.from_numpy(x))


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", MOE)
def test_server_matches_reference(arch):
    """Five requests through two slots, the last prompt 300 tokens long so
    that its prefill takes the capacity path: the reference's greedy token
    lists.  Logits a step within 1e-3: each server attends over its own
    bfloat16 cache, and over 300 tokens some keys round an ulp apart (see
    ``test_prefill_decode_logits_match_reference``), which moves a logit by
    a few 1e-4 at these widths."""
    server, jserver = _servers(arch=arch, max_len=320)
    calls, jcalls = _record(server, False), _record(jserver, True)
    paths = []
    moe_ffn = transformer.moe_ffn

    def counted(x, *args, **kw):
        paths.append("capacity" if x.shape[0] > transformer.DENSE_PATH_MAX_TOKENS else "exact")
        return moe_ffn(x, *args, **kw)

    def requests(cls):
        lengths = (4, 7, 5, 9, 300)
        return [cls(uid=i, prompt=(np.arange(n, dtype=np.int32) * (i + 3)) % 250 + 1)
                for i, n in enumerate(lengths)]

    transformer.moe_ffn = counted
    try:
        done = server.serve(requests(Request))
    finally:
        transformer.moe_ffn = moe_ffn
    jdone = jserver.serve(requests(JRequest))
    assert [c.uid for c in done] == [c.uid for c in jdone] == [0, 1, 2, 3, 4]
    L = server.model.cfg.n_layers
    assert paths.count("capacity") == L, "one prefill, of every layer, on the capacity path"
    compared, to_the_end = _compare_runs(calls, jcalls, done, jdone, tol=1e-3)
    assert compared >= 5 and to_the_end
    assert [c.tokens for c in done] == [c.tokens for c in jdone]


# ---------------------------------------------------------------------------
# configs, init, convert
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", NEW)
def test_configs_equal_the_reference_field_for_field(arch):
    for get_t, get_j in ((tconfigs.get_config, jconfigs.get_config),
                         (tconfigs.reduced_config, jconfigs.reduced_config)):
        tcfg, jcfg = get_t(arch), get_j(arch)
        names = [f.name for f in dataclasses.fields(jcfg)]
        assert names == [f.name for f in dataclasses.fields(tcfg)]
        for name in names:
            if name == "dtype":
                assert JDT[tcfg.dtype] == jcfg.dtype
            elif name == "moe" and tcfg.moe is not None:
                assert dataclasses.asdict(tcfg.moe) == dataclasses.asdict(jcfg.moe), arch
            else:
                assert getattr(tcfg, name) == getattr(jcfg, name), (arch, name)
        assert tcfg.dh == jcfg.dh
        assert tconfigs.param_count(tcfg) == jconfigs.param_count(jcfg)
        assert tconfigs.active_param_count(tcfg) == jconfigs.active_param_count(jcfg)


def test_full_configs_and_counts():
    """The assigned widths, and the parameter counts of the full configs."""
    moe, llama, vl = (tconfigs.get_config(a) for a in NEW)
    assert (moe.n_layers, moe.d_model, moe.n_heads, moe.dh, moe.vocab) == \
        (24, 2048, 16, 128, 151936)
    assert (moe.moe.n_experts, moe.moe.top_k, moe.moe.d_ff_expert, moe.moe.d_ff_shared,
            moe.moe.shared_gate) == (60, 4, 1408, 5632, True)
    assert (llama.n_layers, llama.d_model, llama.n_heads, llama.n_kv_heads, llama.dh) == \
        (48, 5120, 40, 8, 128)
    assert (llama.moe.n_experts, llama.moe.top_k, llama.attn_chunk, llama.global_period) == \
        (16, 1, 8192, 4)
    assert (vl.n_layers, vl.d_model, vl.n_heads, vl.n_kv_heads, vl.dh, vl.tie_embeddings) == \
        (28, 1536, 12, 2, 128, True)
    assert tconfigs.param_count(moe) == 14_315_782_144
    assert 90e9 <= tconfigs.param_count(llama) <= 130e9
    assert tconfigs.active_param_count(llama) < tconfigs.param_count(llama) / 5
    for arch in NEW:
        assert tconfigs.get_config(arch.replace("_", "-")) is tconfigs.get_config(arch)


@pytest.mark.parametrize("arch", NEW)
def test_init_matches_reference_layout(arch):
    """Same keys, shapes and dtypes as the reference's ``init_params``; the
    count is ``param_count`` plus the final norm (and the vlm's
    ``patch_proj``); matrices at std ``1/sqrt(fan_in)`` (truncated)."""
    tcfg, jcfg = _configs(arch, torch.bfloat16)
    model = Model(tcfg, device="cpu").init(seed=0)
    jshapes = jax.eval_shape(lambda k: jtransformer.init_params(jcfg, k)[0], jax.random.PRNGKey(0))
    want = {name: tuple(s.shape) for name, s in convert._flatten(
        jax.tree.map(lambda s: np.empty(s.shape, np.int8), jshapes)).items()}
    sd = model.state_dict()
    assert {name: tuple(p.shape) for name, p in sd.items()} == want
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    extra = tcfg.d_model + (tcfg.d_model ** 2 if tcfg.family == "vlm" else 0)
    assert sum(p.numel() for p in model.parameters()) == tconfigs.param_count(tcfg) + extra
    assert float(sd["final_ln"].abs().max()) == 0.0
    for name, p in sd.items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf.startswith(("ln", "b")) or leaf in ("final_ln", "embed"):
            continue
        scaled = p.float() * math.sqrt(p.shape[-2])
        assert float(scaled.abs().max()) <= 2.0 * 1.01, name       # truncated at 2 sigma
        if p.numel() >= 4096:
            assert abs(float(scaled.std()) - 0.8796) < 0.06, name


def test_convert_round_trip_of_the_moe_leaves():
    tcfg, _ = _configs("qwen2_moe_a2_7b", torch.bfloat16)
    tree = _weights(tcfg)
    state = convert.params_from_reference(tree, tcfg, device="cpu")
    assert {"layers.router", "layers.we_gate", "layers.ws_g"} <= set(state)
    assert state["layers.we_down"].shape == (2, 8, 96, 64)
    again = convert.params_from_reference(convert.params_to_reference(state), tcfg, device="cpu")
    assert all(torch.equal(state[k], again[k]) for k in state)
    missing = {k: v for k, v in tree.items() if k != "layers"}
    missing["layers"] = {k: v for k, v in tree["layers"].items() if k != "ws_g"}
    with pytest.raises(KeyError, match="ws_g"):
        convert.params_from_reference(missing, tcfg, device="cpu")


# ---------------------------------------------------------------------------
# memory at full width: no second copy of the weights
# ---------------------------------------------------------------------------


class _Allocations(TorchDispatchMode):
    """Records every tensor an operation creates (not a view, not written in
    place): ``(device type, dtype, elements)``."""

    def __init__(self):
        super().__init__()
        self.made = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        fresh = all(r.alias_info is None for r in func._schema.returns)
        if fresh:
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(t, torch.Tensor):
                    self.made.append((t.device.type, t.dtype, t.numel()))
        return out


def test_init_draws_in_place_block_by_block(monkeypatch):
    """``Model.init`` on stacked leaves: every float32 temporary is at most
    one block, nothing of a leaf's size is made beside the parameters, and the
    drawn values are truncated, at their std and seeded, layer by layer."""
    cfg = dataclasses.replace(tconfigs.reduced_config("qwen2_moe_a2_7b"), n_layers=3)
    block = 4096
    monkeypatch.setattr(common, "DRAW_BLOCK", block)
    model = Model(cfg, device="cpu")
    largest_leaf = max(p.numel() for p in model.parameters())
    with _Allocations() as rec:
        model.init(seed=5)
    assert max(n for dev, dt, n in rec.made if dt == torch.float32) <= block
    assert max(n for dev, dt, n in rec.made) < largest_leaf
    sd = model.state_dict()
    again = Model(cfg, device="cpu").init(seed=5).state_dict()
    other = Model(cfg, device="cpu").init(seed=6).state_dict()
    we = sd["layers.we_gate"]                        # (3, 8, 64, 96): 24,576 elements a layer
    assert we[0].numel() > block
    for layer in range(cfg.n_layers):
        w = we[layer].float() * math.sqrt(we.shape[-2])
        assert float(w.abs().max()) <= 2.0 * 1.01
        assert abs(float(w.std()) - 0.8796) < 0.05
        assert torch.equal(we[layer], again["layers.we_gate"][layer])
        assert not torch.equal(we[layer], other["layers.we_gate"][layer])
    assert not torch.equal(we[0], we[1]) and not torch.equal(we[1], we[2])


def test_trunc_normal_blocks_cover_the_leaf():
    """Blocks go along the leading axes in order and cover every element once."""
    t = torch.zeros(3, 5, 7)
    for limit in (1, 6, 7, 20, 35, 36, 105, 1000):
        parts = list(common.draw_blocks(t, limit))
        assert sum(p.numel() for p in parts) == t.numel()
        assert all(p.numel() <= max(limit, 7) for p in parts)
        for i, p in enumerate(parts):
            p.fill_(i + 1)
        assert bool((t > 0).all())
        t.zero_()


def test_server_adopts_without_a_model_of_its_own():
    """``Server`` builds its model without storage (``meta``) and adopts the
    state dict's tensors: no parameter memory is allocated, and every
    parameter is one of the given tensors."""
    cfg = tconfigs.reduced_config("qwen2_moe_a2_7b")
    state = Model(cfg, device="cpu").init(seed=0).state_dict()
    scfg = ServeConfig(batch_slots=2, max_len=16, max_new_tokens=2)
    with _Allocations() as rec:
        server = Server(cfg, scfg, state, device="cpu")
    assert sum(n for dev, dt, n in rec.made if dev != "meta") == 0
    ptrs = {t.data_ptr() for t in state.values()}
    assert all(p.device.type == "cpu" and p.data_ptr() in ptrs
               for p in server.model.parameters())
    assert not any(p.requires_grad for p in server.model.parameters())
    with pytest.raises(RuntimeError, match="Missing key"):
        Server(cfg, scfg, {k: v for k, v in state.items() if k != "layers.router"}, device="cpu")
