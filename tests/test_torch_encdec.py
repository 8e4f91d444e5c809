"""The port's audio family (whisper) against the JAX package, on the CPU.

Inputs and weights are made with numpy from a seed and handed to both sides
(weights through ``repro_torch.convert``).  The model runs at its
``REDUCED`` size (2 + 2 layers, d_model 64, 4 heads of 16).  Tolerances:
float32 2e-5, for single functions and through the stacks alike; bfloat16
against the reference's own bfloat16 spread.
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
from repro.models import common as jcommon
from repro.models import encdec as jencdec
from repro_torch.models.transformer import PORT_ONLY_FIELDS
from repro_torch import convert
from repro_torch.kernels import ops
from repro_torch.models import Model, common, encdec, param_dtypes, param_shapes

torch.set_num_threads(1)

ARCH = "whisper_large_v3"
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
IMPLS = ["chunked", "xla", "hopper"]
T_FRAMES = 24


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def _configs(dtype=torch.float32):
    tcfg = dataclasses.replace(tconfigs.reduced_config(ARCH), dtype=dtype)
    jcfg = dataclasses.replace(jconfigs.reduced_config(ARCH), dtype=JDT[dtype])
    return tcfg, jcfg


def _weights(tcfg, seed=0):
    """The reference's tree as float32 numpy arrays: matrices at their init
    scale, norm offsets small but not zero."""
    rng = np.random.default_rng(seed)
    flat = {}
    for name, shape in param_shapes(tcfg).items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf.startswith("ln") or leaf in ("enc_ln", "final_ln"):
            std = 0.1
        else:
            std = 0.02 if leaf == "embed" else 1.0 / math.sqrt(shape[-2])
        flat[name] = (rng.standard_normal(shape) * std).astype(np.float32)
    return convert.params_to_reference({k: torch.from_numpy(v) for k, v in flat.items()})


def _both(dtype=torch.float32, attn_impl="chunked", j_impl="chunked", seed=0):
    tcfg, jcfg = _configs(dtype)
    tree = _weights(tcfg, seed)
    jparams = jax.tree.map(lambda x: jnp.asarray(x).astype(jcfg.dtype), tree)
    model = Model(tcfg, attn_impl=attn_impl, device="cpu")
    model.load_state_dict(convert.params_from_reference(tree, tcfg, device="cpu"))
    return model, JModel(jcfg, attn_impl=j_impl), jparams


def _frames(cfg, B=2, T=T_FRAMES, seed=2):
    return np.random.default_rng(seed).standard_normal((B, T, cfg.d_model)).astype(np.float32)


def _tokens(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(1, cfg.vocab, size=(B, S)).astype(np.int32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


# ---------------------------------------------------------------------------
# common.layer_norm / gelu (no model calls them)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_norm(dtype):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 5, 64)) * 3 + 1).astype(np.float32)
    w = (1 + rng.standard_normal(64) * 0.1).astype(np.float32)
    b = (rng.standard_normal(64) * 0.1).astype(np.float32)
    got = common.layer_norm(_t(x).to(dtype), _t(w).to(dtype), _t(b).to(dtype))
    jd = JDT[dtype]
    want = jcommon.layer_norm(jnp.asarray(x).astype(jd), jnp.asarray(w).astype(jd),
                              jnp.asarray(b).astype(jd))
    assert got.dtype == dtype
    _close(got, want, 2e-5 if dtype == torch.float32 else 2e-2)
    unit = common.layer_norm(_t(x), torch.ones(64), torch.zeros(64))
    np.testing.assert_allclose(unit.mean(-1).numpy(), 0.0, atol=1e-5)
    np.testing.assert_allclose(unit.square().mean(-1).numpy(), 1.0, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gelu(dtype):
    x = np.linspace(-6, 6, 301, dtype=np.float32)
    got = common.gelu(_t(x).to(dtype))
    want = jcommon.gelu(jnp.asarray(x).astype(JDT[dtype]))
    assert got.dtype == dtype
    _close(got, want, 2e-5 if dtype == torch.float32 else 2e-2)


# ---------------------------------------------------------------------------
# config, layout
# ---------------------------------------------------------------------------


def test_configs_equal_the_reference_field_for_field():
    from repro_torch.configs import whisper_large_v3 as tmod
    from repro.configs import whisper_large_v3 as jmod

    assert tmod.N_FRAMES == jmod.N_FRAMES == 1500
    for tcfg, jcfg in ((tmod.CONFIG, jmod.CONFIG), (tmod.REDUCED, jmod.REDUCED)):
        names = [f.name for f in dataclasses.fields(jcfg)]
        # the port's own fields (none in the reference) stay at their default
        assert names == [f.name for f in dataclasses.fields(tcfg)
                         if f.name not in PORT_ONLY_FIELDS]
        assert all(getattr(tcfg, f) is None for f in PORT_ONLY_FIELDS)
        for name in names:
            if name == "dtype":
                assert JDT[tcfg.dtype] == jcfg.dtype
            else:
                assert getattr(tcfg, name) == getattr(jcfg, name), name
        assert tcfg.dh == jcfg.dh
        assert tconfigs.param_count(tcfg) == jconfigs.param_count(jcfg)


def test_full_configs_match_assignment():
    cfg = tconfigs.get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, cfg.vocab) == (
        32, 1280, 20, 20, 5120, 51866)
    assert cfg.family == "audio" and cfg.dh == 64
    assert tconfigs.get_config("whisper-large-v3") is cfg


def test_param_counts_plausible():
    """1.96 B by the reference's formula (SwiGLU, cross-attention, no conv
    frontend): near whisper-large-v3's nameplate 1.55 B."""
    n = tconfigs.param_count(tconfigs.get_config(ARCH))
    assert 1.5e9 <= n <= 2.5e9, n
    assert n == jconfigs.param_count(jconfigs.get_config(ARCH)) == 1_955_463_680


def test_init_matches_reference_layout():
    """Same keys, shapes and dtypes as the reference's ``init_params``; the
    count is ``param_count`` plus every norm (which the formula leaves out)."""
    tcfg, jcfg = _configs(torch.bfloat16)
    model = Model(tcfg, device="cpu").init(seed=0)
    jshapes = jax.eval_shape(lambda k: jencdec.init_params(jcfg, k)[0], jax.random.PRNGKey(0))
    want = {name: tuple(s.shape) for name, s in convert._flatten(
        jax.tree.map(lambda s: np.empty(s.shape, np.int8), jshapes)).items()}
    got = {name: tuple(p.shape) for name, p in model.state_dict().items()}
    assert got == want
    assert set(param_dtypes(tcfg).values()) == {torch.bfloat16}
    assert all(p.dtype == torch.bfloat16 and not p.requires_grad for p in model.parameters())
    L, D = tcfg.n_layers, tcfg.d_model
    norms = 2 * L * D + 3 * L * D + 2 * D   # enc ln1/ln2, dec ln1/lnx/ln2, enc_ln, final_ln
    assert sum(p.numel() for p in model.parameters()) == tconfigs.param_count(tcfg) + norms
    sd = model.state_dict()
    for k in ("enc.ln1", "dec.lnx", "enc_ln", "final_ln"):
        assert float(sd[k].abs().max()) == 0.0
    assert abs(float(sd["dec.xq"].float().std()) * math.sqrt(D) - 0.8796) < 0.1
    assert 0.015 < float(sd["embed"].float().std()) < 0.02
    again = Model(tcfg, device="cpu").init(seed=0).state_dict()
    assert all(torch.equal(sd[k], again[k]) for k in sd)


# ---------------------------------------------------------------------------
# encode / decode_train / decode_step against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", IMPLS)
def test_encode_matches_reference(impl):
    model, jmodel, jparams = _both(attn_impl=impl)
    cfg = model.cfg
    fr = _frames(cfg)
    got = encdec.encode(cfg, model.params, _t(fr), impl)
    want = jencdec.encode(jmodel.cfg, jparams, jnp.asarray(fr), "xla" if impl == "hopper" else impl)
    assert got.shape == (2, T_FRAMES, cfg.d_model) and got.dtype == torch.float32
    _close(got, want, 2e-5)


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("impl", ["chunked", "xla"])
def test_decode_train_matches_reference(impl, remat):
    model, jmodel, jparams = _both(attn_impl=impl)
    cfg = model.cfg
    fr, toks = _frames(cfg), _tokens(cfg, 2, 12)
    jenc = jencdec.encode(jmodel.cfg, jparams, jnp.asarray(fr), impl)
    want = jencdec.decode_train(jmodel.cfg, jparams, jenc, jnp.asarray(toks), impl, remat)
    enc = encdec.encode(cfg, model.params, _t(fr), impl)
    got = encdec.decode_train(cfg, model.params, enc, _t(toks), impl, remat)
    assert got.shape == (2, 12, cfg.d_model)
    _close(got, want, 2e-5)


@pytest.mark.parametrize("impl", IMPLS)
def test_decode_step_matches_reference(impl):
    """A prefill and five decode steps through ``Model``, held step by step
    against the reference's: hidden states, logits (tied head) and the
    self-attention caches."""
    model, jmodel, jparams = _both(attn_impl=impl)
    cfg = model.cfg
    fr = _frames(cfg)
    toks = _tokens(cfg, 2, 5)
    batch = {"tokens": _t(toks[:, :1]), "frame_embeds": _t(fr)}
    jbatch = {"tokens": jnp.asarray(toks[:, :1]), "frame_embeds": jnp.asarray(fr)}
    h, state = model.prefill(batch, 8)
    jh, jstate = jmodel.prefill(jparams, jbatch, 8)
    _close(h, jh, 2e-5)
    for i in range(5):
        tok = toks[:, i:i + 1]
        h, state = model.decode_step(_t(tok), state)
        jh, jstate = jmodel.decode_step(jparams, jnp.asarray(tok), jstate)
        _close(h, jh, 2e-5)
        _close(model.logits(h), jmodel.logits(jparams, jh), 2e-5)
    for got, want in zip(state["kv"], jstate["kv"]):
        _close(got, want, 2e-5)
    assert state["pos"].tolist() == np.asarray(jstate["pos"]).tolist() == [5, 5]


@pytest.mark.parametrize("impl", IMPLS)
def test_decode_step_matches_reference_decode_train(impl):
    """The reference has no audio case of ``test_decode_consistency_with_forward``:
    the port's step-by-step decode (float32 caches) against the reference's
    teacher-forced pass at the same positions."""
    model, jmodel, jparams = _both(attn_impl=impl)
    cfg = model.cfg
    fr, toks = _frames(cfg), _tokens(cfg, 2, 7)
    jenc = jencdec.encode(jmodel.cfg, jparams, jnp.asarray(fr), "chunked")
    want = jencdec.decode_train(jmodel.cfg, jparams, jenc, jnp.asarray(toks), "chunked")
    _, state = model.prefill({"tokens": _t(toks), "frame_embeds": _t(fr)}, 10)
    for i in range(toks.shape[1]):
        h, state = model.decode_step(_t(toks[:, i:i + 1]), state)
        _close(h[:, 0], want[:, i], 2e-5)


def test_prefill_returns_the_encoder_output_and_state():
    """The encoder output, empty caches in ``cfg.dtype`` and position 0 for
    every row; the prompt's tokens give only the batch size (as in the
    reference)."""
    for dtype in (torch.float32, torch.bfloat16):
        model, jmodel, jparams = _both(dtype)
        cfg = model.cfg
        fr = _frames(cfg, B=3)
        h, state = model.prefill({"tokens": _t(_tokens(cfg, 3, 6)), "frame_embeds": _t(fr)}, 16)
        jh, jstate = jmodel.prefill(jparams, {"tokens": jnp.asarray(_tokens(cfg, 3, 6)),
                                              "frame_embeds": jnp.asarray(fr)}, 16)
        assert sorted(state) == sorted(jstate) == ["enc", "kv", "pos"]
        assert h is state["enc"] and h.shape == (3, T_FRAMES, cfg.d_model) and h.dtype == dtype
        for got, want in zip(state["kv"], jstate["kv"]):
            assert got.shape == want.shape == (cfg.n_layers, 3, 16, cfg.n_kv_heads, cfg.dh)
            assert got.dtype == dtype and not got.any()
        assert state["pos"].dtype == torch.int32 and state["pos"].tolist() == [0, 0, 0]
        tol = 2e-5 if dtype == torch.float32 else 5e-2
        _close(h, jh, tol)
        # other prompt tokens, the same encoder output
        h2, _ = model.prefill({"tokens": _t(_tokens(cfg, 3, 2, seed=9)),
                               "frame_embeds": _t(fr)}, 16)
        assert torch.equal(h, h2)


def test_bfloat16_matches_reference():
    """bfloat16 through the kernel's plain path: the port's run held to the
    reference's float32 run no worse than the reference's own bfloat16 run
    is held (mean error 1.25x, largest error 2x), over the encoder output
    and three decode steps; the logits to 5e-2 directly."""
    model, jmodel, jparams = _both(torch.bfloat16, attn_impl="hopper")
    _, jmodel32, jparams32 = _both()
    cfg = model.cfg
    fr, toks = _frames(cfg), _tokens(cfg, 2, 3)
    jb = {"tokens": jnp.asarray(toks[:, :1]), "frame_embeds": jnp.asarray(fr)}
    truth, st32 = jmodel32.prefill(jparams32, jb, 8)
    jh, jst = jmodel.prefill(jparams, jb, 8)
    h, st = model.prefill({"tokens": _t(toks[:, :1]), "frame_embeds": _t(fr)}, 8)
    outs = [(h, jh, truth)]
    for i in range(3):
        tok = toks[:, i:i + 1]
        truth, st32 = jmodel32.decode_step(jparams32, jnp.asarray(tok), st32)
        jh, jst = jmodel.decode_step(jparams, jnp.asarray(tok), jst)
        h, st = model.decode_step(_t(tok), st)
        outs.append((h, jh, truth))
    for h, jh, truth in outs:
        assert h.dtype == torch.bfloat16
        err_port = np.abs(_np(h) - _np(truth))
        err_ref = np.abs(_np(jh) - _np(truth))
        assert err_port.mean() <= 1.25 * err_ref.mean(), (err_port.mean(), err_ref.mean())
        assert err_port.max() <= 2.0 * err_ref.max(), (err_port.max(), err_ref.max())
    _close(model.logits(h), jmodel.logits(jparams, jh), 5e-2)


def test_the_kernel_wrapper_is_reached_on_all_three_attentions(monkeypatch):
    """``attn_impl="hopper"``: the encoder's self-attention once a layer at
    prefill (every query sees every frame), then a decode step's
    self-attention and cross-attention, twice a layer; the plain paths keep
    the reference's ``"chunked"`` self-attention at decode."""
    calls = []
    wrapper = ops.flash_attention

    def counted(q, k, v, qpos, kpos, **kw):
        calls.append((q.shape[1], k.shape[1], int(qpos.min()), int(qpos.max())))
        return wrapper(q, k, v, qpos, kpos, **kw)

    monkeypatch.setattr(ops, "flash_attention", counted)
    model, _, _ = _both(attn_impl="hopper")
    cfg = model.cfg
    L = cfg.n_layers
    _, state = model.prefill({"tokens": _t(_tokens(cfg, 2, 1)), "frame_embeds": _t(_frames(cfg))},
                             8)
    assert calls == [(T_FRAMES, T_FRAMES, T_FRAMES, T_FRAMES)] * L
    calls.clear()
    model.decode_step(_t(_tokens(cfg, 2, 1)), state)
    assert calls == [(1, 8, 0, 0), (1, T_FRAMES, T_FRAMES, T_FRAMES)] * L
    assert encdec.decode_self_impl("hopper") == "hopper"
    assert encdec.decode_self_impl("xla") == encdec.decode_self_impl("chunked") == "chunked"
    calls.clear()
    model.attn_impl = "xla"
    model.prefill({"tokens": _t(_tokens(cfg, 2, 1)), "frame_embeds": _t(_frames(cfg))}, 8)
    assert calls == []


def test_cache_insert_past_the_end_raises():
    """The reference clamps an insert past the cache's end (its
    ``dynamic_update_slice``) and so overwrites the tail; the port raises."""
    model, _, _ = _both()
    cfg = model.cfg
    _, state = model.prefill({"tokens": _t(_tokens(cfg, 2, 1)), "frame_embeds": _t(_frames(cfg))},
                             3)
    for _ in range(3):
        _, state = model.decode_step(_t(_tokens(cfg, 2, 1)), state)
    before = [c.clone() for c in state["kv"]]
    with pytest.raises(ValueError, match="cannot take"):
        model.decode_step(_t(_tokens(cfg, 2, 1)), state)
    assert all(torch.equal(a, b) for a, b in zip(before, state["kv"]))


def test_convert_carries_the_audio_state():
    """The reference's decode state (caches and encoder output in
    ``cfg.dtype``) carried into the port decodes as the port's own does."""
    model, jmodel, jparams = _both()
    cfg = model.cfg
    fr, toks = _frames(cfg), _tokens(cfg, 2, 3)
    _, jstate = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks[:, :1]),
                                         "frame_embeds": jnp.asarray(fr)}, 8)
    for i in range(2):
        _, jstate = jmodel.decode_step(jparams, jnp.asarray(toks[:, i:i + 1]), jstate)
    host = jax.tree.map(np.asarray, jstate)
    state = convert.state_from_reference(host, device="cpu", kv_dtype=cfg.dtype)
    assert sorted(state) == ["enc", "kv", "pos"] and state["enc"].dtype == torch.float32
    jh, _ = jmodel.decode_step(jparams, jnp.asarray(toks[:, 2:3]), jstate)
    h, state = model.decode_step(_t(toks[:, 2:3]), state)
    _close(h, jh, 2e-5)
    back = convert.state_to_reference(state)
    assert back["enc"].shape == (2, T_FRAMES, cfg.d_model) and back["pos"].tolist() == [3, 3]
