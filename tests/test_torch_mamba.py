"""The port's Mamba2 layer, ssm and hybrid models against the JAX package, on the CPU.

Weights are made with numpy from a seed in the reference's tree and handed to
both sides (to JAX as arrays, to the port through ``repro_torch.convert``).
Models run at their ``REDUCED`` size in float32 unless a test says otherwise.
Tolerances: 2e-5 for one layer, 1e-4 for hidden states, states and logits
through the stack (float32 sums in another order, layer after layer: the dense
slice's bound), 5e-2 in bfloat16 and where a bfloat16 cache or conv state
stands between the two sides.  ``ssd_impl="hopper"`` runs the SSD kernel's
plain version here (CPU tensors); ``chip_smoke.py`` runs the kernel itself.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.models import Model as JModel
from repro.models import hybrid as jhybrid
from repro.models import mamba2 as jmamba2
from repro_torch.models.transformer import PORT_ONLY_FIELDS
from repro_torch import convert
from repro_torch.kernels import mamba2_ssd as ssd
from repro_torch.models import Model, hybrid, mamba2, param_dtypes, param_shapes, ssm

torch.set_num_threads(1)

ARCHS = ["mamba2_370m", "zamba2_2_7b"]
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def _configs(arch, dtype=torch.float32):
    tcfg = dataclasses.replace(tconfigs.reduced_config(arch), dtype=dtype)
    jcfg = dataclasses.replace(jconfigs.reduced_config(arch), dtype=JDT[dtype])
    return tcfg, jcfg


def _leaf_std(leaf, shape):
    if leaf in ("ln", "norm", "final_ln", "ln1", "ln2", "conv_b", "dt_bias"):
        return 0.1
    if leaf == "conv_w":
        return 0.2
    if leaf == "embed":
        return 0.02
    return 1.0 / math.sqrt(shape[-2])


def _weights(tcfg, seed=0):
    """The reference's parameter tree as float32 numpy arrays: matrices at
    their init scale, norm offsets and biases small but not zero, ``a_log``
    around the reference's ``log(linspace(1, 16, H))``, ``d_skip`` around 1."""
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


def _both(arch, dtype=torch.float32, ssd_impl="chunked", attn_impl="chunked", seed=0):
    tcfg, jcfg = _configs(arch, dtype)
    tree = _weights(tcfg, seed)
    jparams = jax.tree.map(jnp.asarray, tree)
    jparams = {
        k: (jax.tree.map(lambda x: x.astype(jcfg.dtype), v) if k != "mamba" else
            {leaf: x if leaf in mamba2.FP32_LEAVES else x.astype(jcfg.dtype)
             for leaf, x in v.items()})
        for k, v in jparams.items()
    }
    model = Model(tcfg, attn_impl=attn_impl, ssd_impl=ssd_impl, device="cpu")
    model.load_state_dict(convert.params_from_reference(tree, tcfg, device="cpu"))
    return model, JModel(jcfg, attn_impl="chunked"), jparams


def _tokens(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(1, cfg.vocab, size=(B, S)).astype(np.int32)


def _layer_inputs(B, S, D, seed=3):
    return (np.random.default_rng(seed).standard_normal((B, S, D)) * 0.5).astype(np.float32)


# ---------------------------------------------------------------------------
# mamba2.py: the SSD core and one layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S,chunk", [(16, 16), (20, 16), (7, 256)])
def test_ssd_chunked_matches_reference(S, chunk):
    rng = np.random.default_rng(S)
    B, H, P, N = 2, 3, 16, 32
    x = (rng.standard_normal((B, S, H, P)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    a = (-np.exp(rng.standard_normal(H) * 0.3)).astype(np.float32)
    bm = (rng.standard_normal((B, S, 1, N)) * 0.4).astype(np.float32)
    cm = (rng.standard_normal((B, S, 1, N)) * 0.4).astype(np.float32)
    h0 = (rng.standard_normal((B, H, P, N)) * 0.3).astype(np.float32)
    args = (x, dt, a, bm, cm)
    got = mamba2.ssd_chunked(*(torch.from_numpy(v) for v in args), chunk=chunk,
                             h0=torch.from_numpy(h0))
    want = jmamba2.ssd_chunked(*(jnp.asarray(v) for v in args), chunk=chunk, h0=jnp.asarray(h0))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close(g, w, 1e-5)
    seg = mamba2._segsum(torch.from_numpy(dt[0, :, 0]))
    # -inf above the diagonal on both sides; cumulative sums in another order below
    _close(seg, jmamba2._segsum(jnp.asarray(dt[0, :, 0])), 1e-5)


def test_ssd_decode_step_and_causal_conv_match_reference():
    rng = np.random.default_rng(0)
    B, H, P, N, C = 2, 3, 16, 8, 24
    xs = [rng.standard_normal(s).astype(np.float32) for s in
          ((B, H, P), (B, H), (H,), (B, N), (B, N), (B, H, P, N))]
    xs[1] = np.abs(xs[1])
    got = mamba2.ssd_decode_step(*(torch.from_numpy(v) for v in xs))
    want = jmamba2.ssd_decode_step(*(jnp.asarray(v) for v in xs))
    for g, w in zip(got, want):
        _close(g, w, 2e-5)
    u, w, b = (rng.standard_normal(s).astype(np.float32) for s in ((B, 9, C), (4, C), (C,)))
    _close(mamba2._causal_conv(*(torch.from_numpy(v) for v in (u, w, b))),
           jmamba2._causal_conv(*(jnp.asarray(v) for v in (u, w, b))), 2e-6)


def _layer(arch="mamba2_370m", seed=0):
    tcfg, _ = _configs(arch)
    tree = _weights(tcfg, seed)
    lp = {k: v[0] for k, v in tree["mamba"].items()}
    dims = (tcfg.ssm_heads, tcfg.ssm_head_dim, tcfg.ssm_state)
    return tcfg, lp, dims


@pytest.mark.parametrize("ssd_impl", ["chunked", "hopper"])
@pytest.mark.parametrize("S", [1, 2, 3, 20, 70])
def test_mamba_layer_prefill_matches_reference(ssd_impl, S):
    """Prefill of one layer: hidden states, the last SSM state and the conv
    state (``None`` for a prompt shorter than ``D_CONV - 1``, as the
    reference), as a bfloat16 state buffer stores it."""
    tcfg, lp, dims = _layer()
    h = _layer_inputs(2, S, tcfg.d_model)
    got = mamba2.mamba_layer({k: torch.from_numpy(v) for k, v in lp.items()},
                             torch.from_numpy(h), *dims, chunk=tcfg.ssm_chunk, ssd_impl=ssd_impl)
    want = jmamba2.mamba_layer({k: jnp.asarray(v) for k, v in lp.items()}, jnp.asarray(h), *dims,
                               chunk=tcfg.ssm_chunk)
    _close(got[0], want[0], 2e-5)
    _close(got[1], want[1], 2e-5)
    if S < mamba2.D_CONV - 1:
        assert got[2] is None and want[2] is None
    else:
        assert got[2].dtype == torch.float32 and want[2].dtype == jnp.bfloat16
        _close(got[2].bfloat16(), want[2], 0.0)


@pytest.mark.parametrize("ssd_impl", ["chunked", "hopper"])
def test_mamba_layer_decode_matches_reference(ssd_impl):
    """One token against a carried state; ``ssd_impl`` does not touch decode.
    The conv state as a bfloat16 state buffer stores it."""
    tcfg, lp, dims = _layer()
    rng = np.random.default_rng(9)
    _, conv_dim = mamba2.mamba_dims(tcfg.d_model, *dims)
    h = _layer_inputs(2, 1, tcfg.d_model)
    ssm_state = (rng.standard_normal((2,) + dims) * 0.3).astype(np.float32)
    conv_state = jnp.asarray(rng.standard_normal((2, 3, conv_dim)).astype(np.float32)).astype(
        jnp.bfloat16)
    got = mamba2.mamba_layer(
        {k: torch.from_numpy(v) for k, v in lp.items()}, torch.from_numpy(h), *dims,
        ssm_state=torch.from_numpy(ssm_state),
        conv_state=torch.tensor(_np(conv_state)).bfloat16(),
        decode=True, ssd_impl=ssd_impl)
    want = jmamba2.mamba_layer({k: jnp.asarray(v) for k, v in lp.items()}, jnp.asarray(h), *dims,
                               ssm_state=jnp.asarray(ssm_state), conv_state=conv_state,
                               decode=True)
    _close(got[0], want[0], 2e-5)
    _close(got[1], want[1], 2e-5)
    assert got[2].dtype == torch.float32 and want[2].dtype == jnp.bfloat16
    _close(got[2].bfloat16(), want[2], 2e-5)


def test_mamba_layer_bfloat16_matches_reference():
    """A bfloat16 layer with float32 a_log / d_skip / dt_bias, as the
    reference keeps them; through the SSD kernel's plain version."""
    tcfg, lp, dims = _layer()
    h = _layer_inputs(2, 40, tcfg.d_model)
    tl = {k: torch.from_numpy(v).to(mamba2.leaf_dtype(k, torch.bfloat16)) for k, v in lp.items()}
    jl = {k: jnp.asarray(v).astype(jnp.float32 if k in mamba2.FP32_LEAVES else jnp.bfloat16)
          for k, v in lp.items()}
    got = mamba2.mamba_layer(tl, torch.from_numpy(h).bfloat16(), *dims, chunk=tcfg.ssm_chunk,
                             ssd_impl="hopper")
    want = jmamba2.mamba_layer(jl, jnp.asarray(h).astype(jnp.bfloat16), *dims,
                               chunk=tcfg.ssm_chunk)
    assert got[0].dtype == torch.bfloat16
    _close(got[0], want[0], 5e-2)
    _close(got[1], want[1], 5e-2)


def test_unknown_ssd_impl():
    tcfg, lp, dims = _layer()
    h = torch.from_numpy(_layer_inputs(1, 4, tcfg.d_model))
    with pytest.raises(ValueError, match="chunked or hopper"):
        mamba2.mamba_layer({k: torch.from_numpy(v) for k, v in lp.items()}, h, *dims,
                           ssd_impl="pallas")
    with pytest.raises(ValueError, match="chunked or hopper"):
        Model(tcfg, ssd_impl="pallas", device="cpu")


def test_layer_reaches_the_kernel_wrapper(monkeypatch):
    """``ssd_impl="hopper"`` calls ``ops.mamba2_ssd`` once a prefill layer, with
    x / B / C as strided views of the convolution's output and y in float32;
    decode and ``"chunked"`` do not call it."""
    from repro_torch.kernels import ops

    calls = []
    real = ops.mamba2_ssd

    def spy(x, dt, a, bm, cm, **kw):
        calls.append((x.is_contiguous(), bm.stride(), kw["out_dtype"]))
        return real(x, dt, a, bm, cm, **kw)

    monkeypatch.setattr(ops, "mamba2_ssd", spy)
    model, _, _ = _both("mamba2_370m", ssd_impl="hopper")
    toks = torch.from_numpy(_tokens(model.cfg, 2, 9))
    _, state = model.prefill({"tokens": toks[:, :8]}, max_len=16)
    assert len(calls) == model.cfg.n_layers
    _, conv_dim = mamba2.mamba_dims(model.cfg.d_model, model.cfg.ssm_heads,
                                    model.cfg.ssm_head_dim, model.cfg.ssm_state)
    assert all(c == (False, (8 * conv_dim, conv_dim, 1), torch.float32) for c in calls)
    model.decode_step(toks[:, 8:9], state)
    model.ssd_impl = "chunked"
    model.prefill({"tokens": toks[:, :8]}, max_len=16)
    assert len(calls) == model.cfg.n_layers


# ---------------------------------------------------------------------------
# Model: the ssm and hybrid families, carried weights, float32
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("ssd_impl", ["chunked", "hopper"])
def test_prefill_decode_logits_match_reference(arch, ssd_impl):
    model, jmodel, jparams = _both(arch, ssd_impl=ssd_impl,
                                   attn_impl="hopper" if ssd_impl == "hopper" else "chunked")
    cfg = model.cfg
    toks = _tokens(cfg, 2, 21)
    max_len = 32
    jh, jstate = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks[:, :20])}, max_len)
    h, state = model.prefill({"tokens": torch.from_numpy(toks[:, :20])}, max_len)
    _close(h, jh, 1e-4)
    _close(model.logits(h[:, -1:]), jmodel.logits(jparams, jh[:, -1:]), 1e-4)
    assert sorted(state) == sorted(jstate)
    assert state["pos"].tolist() == np.asarray(jstate["pos"]).tolist() == [20, 20]
    assert state["ssm"].dtype == torch.float32 and state["conv"].dtype == torch.bfloat16
    _close(state["ssm"], jstate["ssm"], 1e-4)
    # the conv states are bfloat16 roundings of values that agree to 1e-4
    _close(state["conv"], jstate["conv"], 2e-2)
    if cfg.family == "hybrid":
        assert len(state["kv"]) == 2 and state["kv"][0].dtype == cfg.dtype
        assert state["kv"][0].shape == (hybrid.n_attn_applications(cfg), 2, max_len,
                                        cfg.n_kv_heads, cfg.dh)
        for got, want in zip(state["kv"], jstate["kv"]):
            _close(got, want, 1e-4)

    # the same state carried across (as numpy) gives the reference's step
    jh2, jstate2 = jmodel.decode_step(jparams, jnp.asarray(toks[:, 20:21]), jstate)
    carried = convert.state_from_reference(
        {k: (tuple(_np(x) for x in v) if isinstance(v, tuple) else _np(v))
         for k, v in jstate.items()}, device="cpu", kv_dtype=cfg.dtype)
    h2, state2 = model.decode_step(torch.from_numpy(toks[:, 20:21]), carried)
    assert h2.shape == (2, 1, cfg.d_model)
    _close(h2, jh2, 1e-4)
    _close(model.logits(h2), jmodel.logits(jparams, jh2), 1e-4)
    assert state2["ssm"] is carried["ssm"], "the state is updated in place"
    back = convert.state_to_reference(state2)
    assert sorted(back) == sorted(jstate2) and back["pos"].tolist() == [21, 21]
    _close(back["ssm"], jstate2["ssm"], 1e-4)
    _close(back["conv"], jstate2["conv"], 2e-2)
    # and the port's own step from its own state agrees as well, within the
    # bfloat16 conv state's rounding
    h3, _ = model.decode_step(torch.from_numpy(toks[:, 20:21]), state)
    _close(h3, jh2, 5e-2)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_bfloat16_matches_reference(arch):
    """bfloat16 through the kernels' paths.  The two frameworks round at other
    places (XLA keeps fused elementwise chains in float32), so after eight
    blocks the hidden states differ by a few bfloat16 spacings of values near
    10; the test holds the port's bfloat16 run to the reference's float32 run
    no worse than the reference's own bfloat16 run is held (mean error 1.25x,
    largest error 2x), and the logits to 5e-2 directly."""
    model, jmodel, jparams = _both(arch, dtype=torch.bfloat16, ssd_impl="hopper",
                                   attn_impl="hopper")
    _, jmodel32, jparams32 = _both(arch)
    toks = _tokens(model.cfg, 2, 24)
    truth, _ = jmodel32.prefill(jparams32, {"tokens": jnp.asarray(toks)}, 32)
    jh, _ = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)}, 32)
    h, _ = model.prefill({"tokens": torch.from_numpy(toks)}, 32)
    assert h.dtype == torch.bfloat16
    err_port = np.abs(_np(h) - _np(truth))
    err_ref = np.abs(_np(jh) - _np(truth))
    assert err_port.mean() <= 1.25 * err_ref.mean(), (err_port.mean(), err_ref.mean())
    assert err_port.max() <= 2.0 * err_ref.max(), (err_port.max(), err_ref.max())
    _close(model.logits(h[:, -1:]), jmodel.logits(jparams, jh[:, -1:]), 5e-2)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_consistency_with_forward(arch):
    """Prefill then one decode step must match the full forward pass, within
    the bfloat16 conv state's quantisation (the reference's own bound)."""
    model, _, _ = _both(arch, ssd_impl="hopper", attn_impl="hopper")
    cfg = model.cfg
    B, S = 2, 8
    toks = torch.from_numpy(_tokens(cfg, B, S + 1))
    if cfg.family == "ssm":
        h_full, _ = ssm.forward(cfg, model.params, toks, ssd_impl=model.ssd_impl)
    else:
        h_full, _ = hybrid.forward(cfg, model.params, toks, attn_impl="xla")
    _, state = model.prefill({"tokens": toks[:, :S]}, max_len=S + 4)
    h_dec, _ = model.decode_step(toks[:, S:S + 1], state)
    assert float((h_dec[:, 0] - h_full[:, S]).abs().max()) < 5e-2


@pytest.mark.parametrize("arch", ARCHS)
def test_arch_smoke_prefill_decode(arch):
    """Reduced config from random weights (bfloat16): shapes, finiteness, the
    position count, and logits near a uniform guess."""
    cfg = tconfigs.reduced_config(arch)
    model = Model(cfg, attn_impl="hopper", ssd_impl="hopper", device="cpu").init(seed=0)
    toks = torch.from_numpy(_tokens(cfg, 2, 8))
    h, state = model.prefill({"tokens": toks}, max_len=16)
    assert h.shape == (2, 8, cfg.d_model)
    tok = model.logits(h[:, -1:]).argmax(-1)
    h2, state2 = model.decode_step(tok, state)
    assert h2.shape == (2, 1, cfg.d_model)
    assert bool(torch.isfinite(h2.float()).all())
    assert state2["pos"].tolist() == [9, 9]
    logits = model.logits(h).float()
    loss = torch.nn.functional.cross_entropy(logits[:, :-1].reshape(-1, cfg.vocab),
                                             toks[:, 1:].reshape(-1).long())
    assert abs(float(loss) - math.log(cfg.vocab)) < 1.5


@pytest.mark.parametrize("arch", ARCHS)
def test_short_prompt_keeps_a_zero_conv_state(arch):
    """A prompt shorter than ``D_CONV - 1 = 3`` tokens leaves every layer's conv
    state zero (the reference's ``mamba2.py:219``, ``__init__.py:125-126``):
    the first decode step then convolves over zeros, not over the prompt.
    The port pins the reference's behaviour, it does not repair it."""
    model, jmodel, jparams = _both(arch, ssd_impl="hopper", attn_impl="hopper")
    for S in (1, 2):
        toks = _tokens(model.cfg, 2, S + 1, seed=S)
        jh, jstate = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks[:, :S])}, 8)
        h, state = model.prefill({"tokens": torch.from_numpy(toks[:, :S])}, 8)
        assert float(state["conv"].abs().max()) == 0.0
        assert float(np.abs(_np(jstate["conv"])).max()) == 0.0
        _close(h, jh, 1e-4)
        jh2, _ = jmodel.decode_step(jparams, jnp.asarray(toks[:, S:]), jstate)
        h2, _ = model.decode_step(torch.from_numpy(toks[:, S:]), state)
        _close(h2, jh2, 1e-4)
    _, state = model.prefill({"tokens": torch.from_numpy(_tokens(model.cfg, 2, 3))}, 8)
    assert float(state["conv"].float().abs().min(dim=-1).values.max()) > 0.0


def test_hybrid_groups_and_tail_layers():
    """n_layers not a multiple of attn_period: the tail layers run after the
    last application, as in the reference."""
    tcfg, jcfg = _configs("zamba2_2_7b")
    tcfg = dataclasses.replace(tcfg, n_layers=7)
    jcfg = dataclasses.replace(jcfg, n_layers=7)
    assert hybrid.n_attn_applications(tcfg) == jhybrid.n_attn_applications(jcfg) == 2
    tree = _weights(tcfg)
    model = Model(tcfg, device="cpu")
    model.load_state_dict(convert.params_from_reference(tree, tcfg, device="cpu"))
    toks = _tokens(tcfg, 2, 10)
    ssm, conv = hybrid.init_states(tcfg, 2, "cpu")
    got, state = hybrid.forward(tcfg, model.params, torch.from_numpy(toks),
                                ssm_states=ssm, conv_states=conv)
    want, jstate = jhybrid.forward(jcfg, jax.tree.map(jnp.asarray, tree), jnp.asarray(toks))
    _close(got, want, 1e-4)
    _close(state["ssm"], jstate["ssm"], 1e-4)
    assert state["kv"] is None


# ---------------------------------------------------------------------------
# configs, init, convert
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_reference_field_for_field(arch):
    for get_t, get_j in ((tconfigs.get_config, jconfigs.get_config),
                         (tconfigs.reduced_config, jconfigs.reduced_config)):
        tcfg, jcfg = get_t(arch), get_j(arch)
        names = [f.name for f in dataclasses.fields(jcfg)]
        # the port's own fields (none in the reference) stay at their default
        assert names == [f.name for f in dataclasses.fields(tcfg)
                         if f.name not in PORT_ONLY_FIELDS]
        assert all(getattr(tcfg, f) is None for f in PORT_ONLY_FIELDS)
        for name in names:
            if name == "dtype":
                assert JDT[tcfg.dtype] == jcfg.dtype
            else:
                assert getattr(tcfg, name) == getattr(jcfg, name), (arch, name)
        assert tconfigs.param_count(tcfg) == jconfigs.param_count(jcfg)


def test_full_configs_match_assignment():
    spec = {"mamba2_370m": (48, 1024, 0, 0, 0, 50280),
            "zamba2_2_7b": (54, 2560, 32, 32, 10240, 32000)}
    for arch, (L, D, Hq, Hkv, F, V) in spec.items():
        cfg = tconfigs.get_config(arch)
        assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, cfg.vocab) == (
            L, D, Hq, Hkv, F, V)
    assert tconfigs.get_config("mamba2_370m").ssm_state == 128
    assert tconfigs.get_config("zamba2_2_7b").ssm_state == 64
    # zamba2's shared block has heads of 80, which the attention kernel serves
    assert tconfigs.get_config("zamba2_2_7b").dh == 80
    assert hybrid.n_attn_applications(tconfigs.get_config("zamba2_2_7b")) == 9


@pytest.mark.parametrize("arch,lo,hi", [("mamba2_370m", 3e8, 5e8), ("zamba2_2_7b", 2e9, 3e9)])
def test_param_counts_plausible(arch, lo, hi):
    assert lo <= tconfigs.param_count(tconfigs.get_config(arch)) <= hi


@pytest.mark.parametrize("arch", ARCHS)
def test_init_matches_reference_layout(arch):
    """Same keys, shapes and dtypes as the reference's init; the count of
    parameters is ``param_count`` plus what its formula leaves out."""
    tcfg, jcfg = _configs(arch, torch.bfloat16)
    model = Model(tcfg, device="cpu").init(seed=0)
    jshapes = jax.eval_shape(lambda k: JModel(jcfg).init(k)[0], jax.random.PRNGKey(0))
    flat = convert._flatten(jax.tree.map(lambda s: np.empty(s.shape, s.dtype), jshapes))
    sd = model.state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} == {k: v.shape for k, v in flat.items()}
    for name, t in sd.items():
        want = torch.float32 if flat[name].dtype == np.float32 else torch.bfloat16
        assert t.dtype == want == param_dtypes(tcfg)[name], name
    H, L = tcfg.ssm_heads, tcfg.n_layers
    _, conv_dim = mamba2.mamba_dims(tcfg.d_model, H, tcfg.ssm_head_dim, tcfg.ssm_state)
    n = sum(p.numel() for p in model.parameters())
    # the formula leaves out the final norm, each layer's conv_b / a_log /
    # d_skip / dt_bias and the shared block's two norms
    shared_norms = 2 * tcfg.d_model if tcfg.family == "hybrid" else 0
    assert n == tconfigs.param_count(tcfg) + tcfg.d_model + L * (conv_dim + 3 * H) + shared_norms
    np.testing.assert_allclose(_np(sd["mamba.a_log"][0]), np.log(np.linspace(1, 16, H)), 1e-6)
    assert float(sd["mamba.d_skip"].min()) == 1.0 == float(sd["mamba.d_skip"].max())
    assert 0.015 < float(sd["embed"].float().std()) < 0.025
    again = Model(tcfg, device="cpu").init(seed=0).state_dict()
    assert all(torch.equal(sd[k], again[k]) for k in sd)


def test_convert_keeps_float32_leaves_and_carries_the_ssm_state():
    tcfg, _ = _configs("zamba2_2_7b", torch.bfloat16)
    tree = _weights(tcfg)
    state = convert.params_from_reference(tree, tcfg, device="cpu")
    for name, t in state.items():
        leaf = name.rsplit(".", 1)[-1]
        assert t.dtype == (torch.float32 if leaf in mamba2.FP32_LEAVES else torch.bfloat16), name
    # the float32 leaves arrive unrounded
    np.testing.assert_array_equal(state["mamba.a_log"].numpy(), tree["mamba"]["a_log"])
    # a dtype override moves the cfg.dtype leaves only
    f32 = convert.params_from_reference(tree, tcfg, device="cpu", dtype=torch.float32)
    assert all(t.dtype == torch.float32 for t in f32.values())
    bf = convert.params_from_reference(tree, dataclasses.replace(tcfg, dtype=torch.float32),
                                       device="cpu", dtype=torch.bfloat16)
    assert bf["mamba.a_log"].dtype == torch.float32 and bf["mamba.in_proj"].dtype == torch.bfloat16
    # decode state: ssm float32, conv bfloat16, round trip through numpy
    rng = np.random.default_rng(0)
    ref_state = {"ssm": rng.standard_normal((6, 2, 4, 16, 16)).astype(np.float32),
                 "conv": np.asarray(jnp.asarray(rng.standard_normal((6, 2, 3, 96)),
                                                jnp.bfloat16).astype(jnp.float32)),
                 "kv": (np.zeros((2, 2, 8, 4, 16), np.float32),) * 2,
                 "pos": np.array([5, 7], np.int32)}
    st = convert.state_from_reference(ref_state, device="cpu", kv_dtype=torch.float32)
    assert (st["ssm"].dtype, st["conv"].dtype, st["kv"][0].dtype) == (
        torch.float32, torch.bfloat16, torch.float32)
    back = convert.state_to_reference(st)
    for key in ("ssm", "conv", "pos"):
        np.testing.assert_array_equal(back[key], ref_state[key])
    assert len(back["kv"]) == 2


def test_ssm_state_of_a_float32_model_stays_float32_and_conv_bfloat16():
    model, _, _ = _both("mamba2_370m")
    _, state = model.prefill({"tokens": torch.from_numpy(_tokens(model.cfg, 2, 5))}, 8)
    assert state["ssm"].dtype == torch.float32 and state["conv"].dtype == torch.bfloat16
    assert "kv" not in state
    assert ssd.CHUNK == 64
