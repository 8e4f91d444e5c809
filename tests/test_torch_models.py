"""The port's layers and dense model against the JAX package, on the CPU.

Inputs and weights are made with numpy from a seed and handed to both sides:
to JAX as ``jnp.asarray(x).astype(dtype)``, to the port through
``repro_torch.convert``.  Models run at their ``REDUCED`` size.  Tolerances:
float32 2e-5 for attention and single layers, 1e-4 for hidden states and
logits through the layer stack; bfloat16 5e-2.
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
from repro.models import attention as jattention
from repro.models import common as jcommon
from repro.models import transformer as jtransformer
from repro_torch.models.transformer import PORT_ONLY_FIELDS
from repro_torch import convert
from repro_torch.configs.base import PORT_ONLY_IDS
from repro_torch.models import (
    FAMILIES, Model, ModelConfig, MoEConfig, attention, common, transformer,
)

torch.set_num_threads(1)

DENSE = ["stablelm_3b", "qwen2_7b", "granite_8b", "gemma3_1b"]
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def _configs(arch, dtype=torch.float32, attn_impl="chunked"):
    tcfg = dataclasses.replace(tconfigs.reduced_config(arch), dtype=dtype)
    jcfg = dataclasses.replace(jconfigs.reduced_config(arch), dtype=JDT[dtype])
    if attn_impl == "hopper" and tcfg.dh % 16:
        # reduced qwen2_7b has 14-wide heads; the kernel takes multiples of 16
        # (the full config's are 128 wide), so its path is tested at 16
        tcfg = dataclasses.replace(tcfg, head_dim=16)
        jcfg = dataclasses.replace(jcfg, head_dim=16)
    return tcfg, jcfg


def _weights(tcfg, seed=0):
    """The reference's parameter tree as float32 numpy arrays: matrices at
    their init scale, norm offsets and biases small but not zero."""
    rng = np.random.default_rng(seed)
    flat = {}
    for name, shape in transformer.param_shapes(tcfg).items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf.startswith(("ln", "b")) or leaf == "final_ln":
            std = 0.1
        else:
            std = 0.02 if leaf == "embed" else 1.0 / math.sqrt(shape[-2])
        flat[name] = (rng.standard_normal(shape) * std).astype(np.float32)
    return convert.params_to_reference({k: torch.from_numpy(v) for k, v in flat.items()})


def _both(arch, dtype=torch.float32, attn_impl="chunked", j_impl="chunked", seed=0):
    tcfg, jcfg = _configs(arch, dtype, attn_impl)
    tree = _weights(tcfg, seed)
    jparams = jax.tree.map(lambda x: jnp.asarray(x).astype(jcfg.dtype), tree)
    model = Model(tcfg, attn_impl=attn_impl, device="cpu")
    model.load_state_dict(convert.params_from_reference(tree, tcfg, device="cpu"))
    return model, JModel(jcfg, attn_impl=j_impl), jparams


def _tokens(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(1, cfg.vocab, size=(B, S)).astype(np.int32)


# ---------------------------------------------------------------------------
# common.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rms_norm(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    w = (rng.standard_normal(64) * 0.1).astype(np.float32)
    got = common.rms_norm(torch.from_numpy(x).to(dtype), torch.from_numpy(w).to(dtype))
    want = jcommon.rms_norm(jnp.asarray(x).astype(JDT[dtype]), jnp.asarray(w).astype(JDT[dtype]))
    assert got.dtype == dtype
    _close(got, want, 2e-5 if dtype == torch.float32 else 2e-2)
    # the scale is stored as an offset from one: zeros leave the norm alone
    unit = common.rms_norm(torch.from_numpy(x), torch.zeros(64))
    np.testing.assert_allclose(unit.square().mean(-1).numpy(), 1.0, atol=1e-4)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
@pytest.mark.parametrize("dh", [16, 80])
def test_apply_rope(dh, theta):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 3, dh)).astype(np.float32)
    pos = rng.integers(0, 500, size=(2, 9)).astype(np.int32)
    got = common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    want = jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    # angles reach hundreds of radians: float32 sin/cos of the two libraries
    # agree to a few 1e-5 there
    _close(got, want, 1e-4)
    _close(common.rope_frequencies(dh, theta), jcommon.rope_frequencies(dh, theta), 1e-6)
    # tables computed once give what the per-call computation gives
    tables = common.rope_sin_cos(torch.from_numpy(pos), dh, theta)
    assert tables[0].shape == tables[1].shape == (2, 9, 1, dh // 2)
    assert torch.equal(common.apply_rope(torch.from_numpy(x), None, theta, sin_cos=tables), got)
    # position 0 is the identity; the split-half form pairs x[i] with x[i + dh/2]
    same = common.apply_rope(torch.from_numpy(x), torch.zeros(2, 9, dtype=torch.int32), theta)
    assert torch.equal(same, torch.from_numpy(x))


def test_swiglu():
    rng = np.random.default_rng(0)
    g = rng.standard_normal((4, 32)).astype(np.float32) * 3
    u = rng.standard_normal((4, 32)).astype(np.float32)
    _close(common.swiglu(torch.from_numpy(g), torch.from_numpy(u)),
           jcommon.swiglu(jnp.asarray(g), jnp.asarray(u)), 2e-6)


@pytest.mark.parametrize("window,chunk", [(None, None), (5, None), (None, 8), (7, 16)])
def test_causal_mask_bias(window, chunk):
    qpos = np.array([[4, 5, 6, 20], [0, 1, 2, 3]], dtype=np.int32)
    kpos = np.broadcast_to(np.arange(24, dtype=np.int32)[None], (2, 24)).copy()
    kpos[1, 20:] = -1
    got = common.causal_mask_bias(torch.from_numpy(qpos), torch.from_numpy(kpos), window, chunk)
    want = jcommon.causal_mask_bias(jnp.asarray(qpos), jnp.asarray(kpos), window, chunk)
    assert got.shape == (2, 1, 4, 24) and got.dtype == torch.float32
    np.testing.assert_array_equal(_np(got), _np(want))


def test_trunc_normal_is_seeded_and_truncated():
    g = torch.Generator().manual_seed(3)
    x = common.trunc_normal(g, (4096,), std=0.5)
    y = common.trunc_normal(torch.Generator().manual_seed(3), (4096,), std=0.5)
    assert torch.equal(x, y)
    assert float(x.abs().max()) <= 1.0 + 1e-6             # two standard deviations
    assert abs(float(x.mean())) < 0.05
    assert abs(float(x.std()) - 0.5 * 0.8796) < 0.03      # std of a normal cut at 2 sigma
    assert common.trunc_normal(g, (3, 2), 1.0, dtype=torch.bfloat16).dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# attention.py
# ---------------------------------------------------------------------------


def _attn_inputs(B=2, S=96, Hq=4, Hkv=2, Dh=32, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, Hq, Dh)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, Dh)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, Dh)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S)).copy()
    return q, k, v, pos


@pytest.mark.parametrize("window,chunk", [(None, None), (17, None), (None, 32)])
def test_attention_paths_agree_with_reference(window, chunk):
    q, k, v, pos = _attn_inputs()
    tq, tk, tv, tpos = (torch.from_numpy(a) for a in (q, k, v, pos))
    jq, jk, jv, jpos = (jnp.asarray(a) for a in (q, k, v, pos))
    want_xla = jattention.attention(jq, jk, jv, jpos, jpos, impl="xla",
                                    window=window, chunk_attn=chunk)
    want_chunked = jattention.attention_chunked(jq, jk, jv, jpos, jpos, window=window,
                                                chunk_attn=chunk, kv_chunk=32)
    got = {
        "xla": attention.attention(tq, tk, tv, tpos, tpos, impl="xla",
                                   window=window, chunk_attn=chunk),
        "chunked": attention.attention_chunked(tq, tk, tv, tpos, tpos, window=window,
                                               chunk_attn=chunk, kv_chunk=32),
        "hopper": attention.attention(tq, tk, tv, tpos, tpos, impl="hopper",
                                      window=window, chunk_attn=chunk),
    }
    _close(got["xla"], want_xla, 2e-5)
    _close(got["chunked"], want_chunked, 2e-5)
    for name, out in got.items():
        _close(out, want_xla, 2e-5)
        assert out.shape == (2, 96, 4, 32), name


def test_attention_chunked_pads_last_chunk():
    """Skv not a multiple of kv_chunk: the tail is padded at position -1."""
    q, k, v, pos = _attn_inputs(S=50)
    tq, tk, tv, tpos = (torch.from_numpy(a) for a in (q, k, v, pos))
    got = attention.attention_chunked(tq, tk, tv, tpos, tpos, kv_chunk=16)
    want = jattention.attention_chunked(*(jnp.asarray(a) for a in (q, k, v, pos, pos)), kv_chunk=16)
    _close(got, want, 2e-5)


def test_attention_promotes_a_bf16_cache_for_a_float32_query():
    q, k, v, pos = _attn_inputs(S=24)
    tq, tpos = torch.from_numpy(q), torch.from_numpy(pos)
    tk, tv = torch.from_numpy(k).bfloat16(), torch.from_numpy(v).bfloat16()
    jk, jv = jnp.asarray(k).astype(jnp.bfloat16), jnp.asarray(v).astype(jnp.bfloat16)
    for impl in ("xla", "chunked", "hopper"):
        got = attention.attention(tq, tk, tv, tpos, tpos, impl=impl)
        want = jattention.attention(jnp.asarray(q), jk, jv, jnp.asarray(pos), jnp.asarray(pos),
                                    impl="chunked")
        assert got.dtype == torch.float32
        _close(got, want, 2e-5)


def test_attention_unknown_impl():
    q, k, v, pos = (torch.from_numpy(a) for a in _attn_inputs(S=8))
    with pytest.raises(ValueError, match="pallas"):
        attention.attention(q, k, v, pos, pos, impl="pallas")


# ---------------------------------------------------------------------------
# transformer.py / Model: carried weights, float32
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("impl", ["xla", "chunked", "hopper"])
def test_forward_matches_reference(arch, impl):
    model, jmodel, jparams = _both(arch, attn_impl=impl)
    toks = _tokens(model.cfg, 2, 24)
    j_impl = "xla" if impl == "xla" else "chunked"
    want, _ = jtransformer.forward(jmodel.cfg, jparams, jnp.asarray(toks), attn_impl=j_impl)
    got, caches = transformer.forward(model.cfg, model.params, torch.from_numpy(toks),
                                      attn_impl=impl)
    assert caches is None and got.shape == (2, 24, model.cfg.d_model)
    _close(got, want, 1e-4)


@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("impl", ["chunked", "hopper"])
def test_prefill_decode_logits_match_reference(arch, impl):
    model, jmodel, jparams = _both(arch, attn_impl=impl)
    cfg = model.cfg
    toks = _tokens(cfg, 2, 9)
    max_len = 16
    jh, jstate = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks[:, :8])}, max_len)
    h, state = model.prefill({"tokens": torch.from_numpy(toks[:, :8])}, max_len)
    _close(h, jh, 1e-4)
    _close(model.logits(h[:, -1:]), jmodel.logits(jparams, jh[:, -1:]), 1e-4)
    assert state["pos"].tolist() == np.asarray(jstate["pos"]).tolist() == [8, 8]
    # the caches hold bfloat16 roundings of keys that agree to 1e-4: one ulp at most
    for got, want in zip(state["kv"], jstate["kv"]):
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        _close(got, want, 2e-2)

    # the port's step against the reference's, each on its own cache ...
    jh2, jstate2 = jmodel.decode_step(jparams, jnp.asarray(toks[:, 8:9]), jstate)
    h2, state2 = model.decode_step(torch.from_numpy(toks[:, 8:9]), state)
    assert h2.shape == (2, 1, cfg.d_model)
    assert state2["pos"].tolist() == np.asarray(jstate2["pos"]).tolist() == [9, 9]
    # ... within the bfloat16 cache's rounding, since the two caches may differ by an ulp
    _close(h2, jh2, 2e-2)
    # and exactly the same state carried across agrees to the float32 tolerance
    carried = convert.state_from_reference(
        {"kv": tuple(_np(x) for x in jstate["kv"]), "pos": np.asarray(jstate["pos"])},
        device="cpu")
    h3, state3 = model.decode_step(torch.from_numpy(toks[:, 8:9]), carried)
    _close(h3, jh2, 1e-4)
    _close(model.logits(h3), jmodel.logits(jparams, jh2), 1e-4)
    back = convert.state_to_reference(state3)
    for got, want in zip(back["kv"], jstate2["kv"]):
        _close(got, want, 2e-2)
    assert back["pos"].tolist() == [9, 9]


def test_forward_bfloat16_matches_reference():
    model, jmodel, jparams = _both("stablelm_3b", dtype=torch.bfloat16)
    toks = _tokens(model.cfg, 2, 16)
    want, _ = jtransformer.forward(jmodel.cfg, jparams, jnp.asarray(toks), attn_impl="chunked")
    got, _ = transformer.forward(model.cfg, model.params, torch.from_numpy(toks))
    assert got.dtype == torch.bfloat16
    _close(got, want, 5e-2)
    _close(model.logits(got), jmodel.logits(jparams, want), 5e-2)


@pytest.mark.parametrize("arch", ["stablelm_3b", "gemma3_1b"])
def test_decode_consistency_with_forward(arch):
    """Decoding against the cache must match the full forward pass, within
    the bfloat16 cache's quantisation (the reference's own bound)."""
    model, _, _ = _both(arch, attn_impl="hopper")
    B, S = 2, 8
    toks = torch.from_numpy(_tokens(model.cfg, B, S + 1))
    h_full, _ = transformer.forward(model.cfg, model.params, toks, attn_impl="xla")
    _, state = model.prefill({"tokens": toks[:, :S]}, max_len=S + 4)
    h_dec, _ = model.decode_step(toks[:, S:S + 1], state)
    assert float((h_dec[:, 0] - h_full[:, S]).abs().max()) < 5e-2


def test_kv_cache_is_bfloat16_whatever_the_model_dtype():
    """A float32 model still attends over bfloat16 keys and values on the
    cached path: the cached and the uncached forward differ, by a rounding."""
    model, _, _ = _both("stablelm_3b")
    cfg = model.cfg
    ck, cv = transformer.init_kv_cache(cfg, 2, 12, device="cpu")
    assert ck.dtype == cv.dtype == torch.bfloat16
    assert ck.shape == (cfg.n_layers, 2, 12, cfg.n_kv_heads, cfg.dh)
    toks = torch.from_numpy(_tokens(cfg, 2, 8))
    cache_pos = torch.arange(12, dtype=torch.int32)[None].expand(2, 12)
    h_cached, (ck2, _) = transformer.forward(cfg, model.params, toks, kv_caches=(ck, cv),
                                             cache_positions=cache_pos)
    h_plain, _ = transformer.forward(cfg, model.params, toks)
    assert ck2 is ck, "the cache is updated in place"
    assert bool(ck[:, :, :8].abs().sum() > 0) and bool((ck[:, :, 8:] == 0).all())
    diff = float((h_cached - h_plain).abs().max())
    assert 1e-5 < diff < 5e-2, diff


def test_block_alone_equals_block_inside_forward():
    """``forward`` computes the rotary tables and the cache index once for all
    layers; a lone ``block`` works them out itself, to the same bits."""
    model, _, _ = _both("gemma3_1b")
    cfg, params = model.cfg, model.params
    toks = torch.from_numpy(_tokens(cfg, 2, 5))
    pos = torch.tensor([[3, 4, 5, 6, 7], [0, 1, 2, 3, 4]], dtype=torch.int32)
    cache_pos = torch.arange(12, dtype=torch.int32)[None].expand(2, 12)
    caches = transformer.init_kv_cache(cfg, 2, 12, device="cpu")
    want, _ = transformer.forward(cfg, params, toks, positions=pos, kv_caches=caches,
                                  cache_positions=cache_pos)
    lone = transformer.init_kv_cache(cfg, 2, 12, device="cpu")
    h = params["embed"][toks].to(cfg.dtype)
    for i, kind in enumerate(cfg.layer_kinds()):
        lp = {name: w[i] for name, w in params["layers"].items()}
        h = transformer.block(cfg, h, lp, kind, pos, "chunked",
                              kv_cache=(lone[0][i], lone[1][i]), cache_positions=cache_pos)
    assert torch.equal(common.rms_norm(h, params["final_ln"]), want)
    assert torch.equal(lone[0], caches[0]) and torch.equal(lone[1], caches[1])
    rows, cols = transformer._cache_index(pos)
    assert rows.tolist() == [[0], [1]] and cols.tolist() == [[3, 4, 5, 6, 7], [0, 1, 2, 3, 4]]
    assert sorted(transformer._rope_tables(cfg, pos)) == [10_000.0, 1_000_000.0]


def test_gemma3_layer_kinds_masks_and_thetas():
    cfg = tconfigs.reduced_config("gemma3_1b")
    jcfg = jconfigs.reduced_config("gemma3_1b")
    kinds = cfg.layer_kinds()
    assert list(kinds) == np.asarray(jcfg.layer_kinds()).tolist() == [0, 0, 0, 0, 0, 1]
    assert transformer._mask_params(cfg, 0) == (16, transformer.BIG)
    assert transformer._mask_params(cfg, 1) == (transformer.BIG, transformer.BIG)
    for kind in (0, 1):
        jw, jc = jtransformer._mask_params(jcfg, jnp.asarray(kind))
        assert (int(jw), int(jc)) == transformer._mask_params(cfg, kind)
    x = np.random.default_rng(0).standard_normal((1, 6, 2, 16)).astype(np.float32)
    pos = np.arange(6, dtype=np.int32)[None]
    for kind in (0, 1):
        got = transformer._rope(cfg, torch.from_numpy(x), torch.from_numpy(pos), kind)
        want = jtransformer._rope(jcfg, jnp.asarray(x), jnp.asarray(pos), jnp.asarray(kind))
        _close(got, want, 2e-5)
    nope = dataclasses.replace(cfg, local_rope_theta=None, nope_on_global=True)
    assert torch.equal(transformer._rope(nope, torch.from_numpy(x), torch.from_numpy(pos), 1),
                       torch.from_numpy(x))


def test_cache_insert_past_the_end_raises():
    """The reference's insert clamps a write that runs past the cache; the port raises."""
    model, _, _ = _both("stablelm_3b")
    toks = torch.from_numpy(_tokens(model.cfg, 1, 9))
    with pytest.raises(ValueError, match="KV cache of length 8"):
        model.prefill({"tokens": toks}, max_len=8)
    _, state = model.prefill({"tokens": toks[:, :8]}, max_len=8)
    with pytest.raises(ValueError, match="KV cache of length 8"):
        model.decode_step(toks[:, 8:9], state)


# ---------------------------------------------------------------------------
# configs, init, convert
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", DENSE)
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
        assert tcfg.dh == jcfg.dh
        assert tconfigs.param_count(tcfg) == jconfigs.param_count(jcfg)
    assert tconfigs.get_config(arch.replace("_", "-")) is tconfigs.get_config(arch)


def test_arch_ids_list_only_what_is_ported():
    """Every architecture of the reference, in its order, each building a
    reduced model; an id the reference does not have raises."""
    ported = DENSE + ["qwen2_moe_a2_7b", "llama4_scout_17b_a16e", "qwen2_vl_2b",
                      "whisper_large_v3", "mamba2_370m", "zamba2_2_7b"]
    assert sorted(tconfigs.ARCH_IDS) == sorted(ported)
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    assert sorted(tconfigs.all_configs()) == sorted(ported)
    with pytest.raises(NotImplementedError, match="not ported yet"):
        tconfigs.get_config("no_such_arch")
    for arch in ported:
        assert Model(tconfigs.reduced_config(arch), device="cpu").cfg.name.endswith("_smoke")


#: what every family module provides (:data:`repro_torch.models.FAMILIES`)
FAMILY_INTERFACE = ("param_shapes", "param_axes", "split_products", "fill_params", "train_loss",
                    "new_state", "prefill", "decode_step", "STATE", "TIED_HEAD",
                    "FLOAT32_LEAVES")


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS + PORT_ONLY_IDS)
def test_every_family_has_the_whole_interface(arch):
    """The family of every configuration is in the table, its module
    provides the whole interface, and a model of it (no storage) holds
    exactly the module's parameters."""
    cfg = tconfigs.get_config(arch)
    assert cfg.family in FAMILIES
    module = FAMILIES[cfg.family]
    missing = [name for name in FAMILY_INTERFACE if not hasattr(module, name)]
    assert not missing, f"{module.__name__} lacks {missing}"
    assert set(module.STATE) <= {"kv", "ssm", "conv", "enc"}
    assert set(module.FLOAT32_LEAVES) <= set(module.param_shapes(cfg))
    model = Model(cfg, device="cpu", storage="meta")
    assert model.family is module
    assert sorted(dict(model.named_parameters())) == sorted(module.param_shapes(cfg))


@pytest.mark.parametrize("arch", DENSE)
def test_init_matches_reference_layout(arch):
    """Same keys, shapes and dtypes as the reference's ``init_params``; the
    count of parameters is ``param_count`` plus the final norm."""
    tcfg, jcfg = _configs(arch, torch.bfloat16)
    model = Model(tcfg, device="cpu").init(seed=0)
    jshapes = jax.eval_shape(lambda k: jtransformer.init_params(jcfg, k)[0], jax.random.PRNGKey(0))
    want = {name: tuple(s.shape) for name, s in convert._flatten(
        jax.tree.map(lambda s: np.empty(s.shape, np.int8), jshapes)).items()}
    got = {name: tuple(p.shape) for name, p in model.state_dict().items()}
    assert got == want
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    n = sum(p.numel() for p in model.parameters())
    assert n == tconfigs.param_count(tcfg) + tcfg.d_model
    sd = model.state_dict()
    assert float(sd["layers.ln1"].abs().max()) == 0.0 and float(sd["final_ln"].abs().max()) == 0.0
    wq = sd["layers.wq"].float()
    assert abs(float(wq.std()) * math.sqrt(tcfg.d_model) - 0.8796) < 0.05
    assert 0.015 < float(sd["embed"].float().std()) < 0.02
    # seeded: the same seed gives the same weights, another seed others
    again = Model(tcfg, device="cpu").init(seed=0).state_dict()
    other = Model(tcfg, device="cpu").init(seed=1).state_dict()
    assert all(torch.equal(sd[k], again[k]) for k in sd)
    assert not torch.equal(sd["layers.wq"], other["layers.wq"])


def test_init_logits_are_healthy():
    """Fresh weights give a next-token loss near ln(vocab), as the reference's do."""
    cfg = dataclasses.replace(tconfigs.reduced_config("stablelm_3b"), dtype=torch.float32)
    model = Model(cfg, attn_impl="xla", device="cpu").init(seed=0)
    toks = torch.from_numpy(_tokens(cfg, 2, 32).astype(np.int64))
    h, _ = transformer.forward(cfg, model.params, toks, attn_impl="xla")
    logits = model.logits(h)
    assert bool(torch.isfinite(logits).all())
    loss = torch.nn.functional.cross_entropy(logits[:, :-1].reshape(-1, cfg.vocab),
                                             toks[:, 1:].reshape(-1))
    assert abs(float(loss) - math.log(cfg.vocab)) < 1.5


def test_convert_round_trip_and_checks():
    tcfg, _ = _configs("qwen2_7b", torch.bfloat16)
    tree = _weights(tcfg)
    state = convert.params_from_reference(tree, tcfg, device="cpu")
    assert set(state) == set(transformer.param_shapes(tcfg))
    assert all(t.dtype == torch.bfloat16 for t in state.values())
    back = convert.params_to_reference(state)
    # bfloat16 travels as float32: a second trip changes nothing
    again = convert.params_from_reference(back, tcfg, device="cpu")
    assert all(torch.equal(state[k], again[k]) for k in state)
    assert back["layers"]["bq"].dtype == np.float32
    f32 = convert.params_from_reference(tree, tcfg, device="cpu", dtype=torch.float32)
    np.testing.assert_array_equal(f32["layers.wq"].numpy(), tree["layers"]["wq"])
    missing = {k: v for k, v in tree.items() if k != "lm_head"}
    with pytest.raises(KeyError, match="lm_head"):
        convert.params_from_reference(missing, tcfg, device="cpu")
    bad = dict(tree, final_ln=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="final_ln"):
        convert.params_from_reference(bad, tcfg, device="cpu")


def test_families_and_options_of_later_slices_raise(tmp_path):
    """Every family of the reference builds; fsdp without a mesh raises (there
    is nothing to shard over), and on a one-rank ``gloo`` mesh fsdp, remesh
    and restoring onto another layout work; an unknown family raises; the
    MoE and M-RoPE options build."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Shard

    from repro_torch.checkpoint import restore_tree, save_tree
    from repro_torch.data import DataConfig
    from repro_torch.launch.mesh import make_host_mesh, start_process_group
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import TrainConfig, Trainer
    from repro_torch.sharding import Sharding

    dense = tconfigs.reduced_config("stablelm_3b")
    audio = tconfigs.reduced_config("whisper_large_v3")
    assert Model(audio, device="cpu").dec["xq"].shape == (2, 64, 64)
    assert tconfigs.param_count(audio) == jconfigs.param_count(jconfigs.reduced_config(
        "whisper_large_v3"))
    with pytest.raises(ValueError, match="unknown family"):
        Model(dataclasses.replace(dense, family="retnet"), device="cpu")
    with pytest.raises(ValueError, match="unknown family"):
        tconfigs.param_count(dataclasses.replace(dense, family="retnet"))
    data = DataConfig(vocab=dense.vocab, seq_len=8, global_batch=2)
    with pytest.raises(ValueError, match="fsdp shards"):
        Trainer(dense, AdamWConfig(), TrainConfig(fsdp=True), data, device="cpu")
    start_process_group("cpu", 0, 1, str(tmp_path / "store"))
    try:
        mesh = make_host_mesh()
        tr = Trainer(dense, AdamWConfig(), TrainConfig(fsdp=True, checkpoint_dir=str(tmp_path / "a")),
                     data, device="cpu", mesh=mesh)
        params, opt = tr.init_state()
        assert isinstance(params["layers.wq"], DTensor) and isinstance(opt["mu"]["embed"], DTensor)
        assert params["layers.wq"].placements == (Shard(1), Shard(2))   # embed on data, heads on model
        plain = Trainer(dense, AdamWConfig(), TrainConfig(checkpoint_dir=str(tmp_path / "b")), data,
                        device="cpu")
        plain.remesh(mesh)
        assert plain.param_shardings()["embed"].spec == ("model", None)
        save_tree(str(tmp_path / "ck"), {"w": torch.arange(4.0)})
        tree, _ = restore_tree(str(tmp_path / "ck"), {"w": torch.zeros(4)},
                               shardings={"w": Sharding(mesh, ("data",))})
        assert isinstance(tree["w"], DTensor)
        assert torch.equal(tree["w"].full_tensor(), torch.arange(4.0))
    finally:
        dist.destroy_process_group()
    moe = dataclasses.replace(dense, family="moe",
                              moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=32))
    assert "layers.we_gate" in transformer.param_shapes(moe)
    assert Model(moe, device="cpu").layers["router"].shape == (2, 64, 4)
    vlm = dataclasses.replace(dense, family="vlm", mrope=True)
    assert transformer.param_shapes(vlm)["patch_proj"] == (64, 64)
    assert isinstance(dense, ModelConfig)
