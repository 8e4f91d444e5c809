"""The port's VLM family (qwen2_vl_2b's backbone) against the JAX package, on the CPU.

``apply_mrope``, the vision-prefix ``forward`` (patch embeddings projected by
``patch_proj`` in place of the first tokens, M-RoPE positions on every
layer), prefill with the prefix and decode with 1-D positions after it, the
tied head, and ``Server.serve`` on reduced qwen2_vl_2b.  Inputs and weights
are made with numpy from a seed and handed to both sides.  Tolerances:
float32 2e-5 per module, 1e-4 at model level; bfloat16 5e-2.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs.qwen2_vl_2b as jqwen2_vl
from repro.models import common as jcommon
from repro.models import transformer as jtransformer
from repro.runtime.serving import Request as JRequest
from repro_torch import convert
from repro_torch.configs import qwen2_vl_2b as tqwen2_vl
from repro_torch.models import common, transformer
from repro_torch.runtime import Request
from test_torch_models import _both, _close, _np, _tokens
from test_torch_serving import _compare_runs, _record, _requests, _servers

torch.set_num_threads(1)

ARCH = "qwen2_vl_2b"


def _mrope_positions(B, S, P, grid):
    """The vision prefix's M-RoPE positions: patch ``i`` of a ``grid x grid``
    image at ``(0, i // grid, i % grid)``, text token ``j`` after it at
    ``grid + j`` on all three streams."""
    pos = np.zeros((B, S, 3), np.int32)
    i = np.arange(P)
    pos[:, :P] = np.stack([np.zeros_like(i), i // grid, i % grid], -1)
    pos[:, P:] = (grid + np.arange(S - P))[:, None]
    return pos


def _patches(B, P, D, seed=4):
    return (np.random.default_rng(seed).standard_normal((B, P, D)) * 0.5).astype(np.float32)


# ---------------------------------------------------------------------------
# common.apply_mrope
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dh", [16, 128])
@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_apply_mrope_matches_reference(dh, theta):
    """Three streams that differ, sections (2, 3, 3) of ``Dh/2`` frequencies
    (bounds by Python's ``round``: 2, 5, 8 at Dh 16; 16, 40, 64 at Dh 128)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 3, dh)).astype(np.float32)
    pos = rng.integers(0, 500, size=(2, 9, 3)).astype(np.int32)
    got = common.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    want = jcommon.apply_mrope(jnp.asarray(x), jnp.asarray(pos), theta)
    _close(got, want, 1e-4)          # angles of hundreds of radians, as test_apply_rope
    # the tables, computed once, give the same bits
    tables = common.mrope_sin_cos(torch.from_numpy(pos), dh, theta)
    assert tables[0].shape == (2, 9, 1, dh // 2)
    assert torch.equal(common.apply_mrope(torch.from_numpy(x), None, theta, sin_cos=tables), got)
    # bfloat16 in, bfloat16 out, rotated in fp32
    got16 = common.apply_mrope(torch.from_numpy(x).bfloat16(), torch.from_numpy(pos), theta)
    want16 = jcommon.apply_mrope(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(pos), theta)
    assert got16.dtype == torch.bfloat16
    _close(got16, want16, 5e-2)


@pytest.mark.parametrize("dh", [16, 128])
def test_mrope_with_equal_streams_is_rope(dh):
    """The port's counterpart of ``test_mrope_differs_from_rope_only_in_rotation``:
    with three equal streams M-RoPE is RoPE at the same theta; with streams
    that differ, each section follows its own stream."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 16, 4, dh)).astype(np.float32))
    pos = torch.arange(16, dtype=torch.int32)[None].expand(2, 16)
    mpos = torch.stack([pos, pos, pos], dim=-1)
    _close(common.apply_mrope(x, mpos, theta=1e6), common.apply_rope(x, pos, theta=1e6), 1e-5)
    want = jcommon.apply_rope(jnp.asarray(x.numpy()), jnp.asarray(pos.numpy()), 1e6)
    _close(common.apply_mrope(x, mpos, theta=1e6), want, 1e-5)
    # move only the width stream: the first two sections' rotation stays that of RoPE
    moved = mpos.clone()
    moved[..., 2] += 7
    sin, cos = common.mrope_sin_cos(moved, dh, 1e6)
    rsin, rcos = common.rope_sin_cos(pos, dh, 1e6)
    width_from = round(dh // 2 * 5 / 8)
    assert torch.equal(sin[..., :width_from], rsin[..., :width_from])
    assert not torch.equal(sin[..., width_from:], rsin[..., width_from:])


def test_mrope_goes_before_the_nope_and_local_theta_rules():
    """``_rope`` applies M-RoPE, where the config asks for it and positions are
    given, whatever the layer's kind; without positions it is plain RoPE."""
    cfg = tqwen2_vl.REDUCED
    jcfg = jqwen2_vl.REDUCED
    odd = dataclasses.replace(cfg, nope_on_global=True, global_period=2)
    jodd = dataclasses.replace(jcfg, nope_on_global=True, global_period=2)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, 6, 2, 16)).astype(np.float32)
    pos = np.arange(6, dtype=np.int32)[None]
    mpos = _mrope_positions(1, 6, 4, 2)
    for kind in (0, 1):
        got = transformer._rope(odd, torch.from_numpy(x), torch.from_numpy(pos), kind,
                                mrope_positions=torch.from_numpy(mpos))
        want = jtransformer._rope(jodd, jnp.asarray(x), jnp.asarray(pos), jnp.asarray(kind),
                                  jnp.asarray(mpos))
        _close(got, want, 2e-5)
        assert not torch.equal(got, torch.from_numpy(x))
    plain = transformer._rope(cfg, torch.from_numpy(x), torch.from_numpy(pos), 1)
    _close(plain, jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), cfg.rope_theta), 2e-5)
    tables = transformer._rope_tables(cfg, torch.from_numpy(pos), torch.from_numpy(mpos))
    assert sorted(tables) == ["mrope"]
    assert sorted(transformer._rope_tables(cfg, torch.from_numpy(pos))) == [cfg.rope_theta]


# ---------------------------------------------------------------------------
# the vision prefix through the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["xla", "chunked", "hopper"])
def test_forward_with_patch_embeds_matches_reference(impl):
    """Eight patch embeddings (a grid of 2 rows of 4) in place of the first
    eight of 24 tokens, M-RoPE positions on every layer."""
    model, jmodel, jparams = _both(ARCH, attn_impl=impl)
    cfg = model.cfg
    B, S, P = 2, 24, 8
    toks, patches = _tokens(cfg, B, S), _patches(B, P, cfg.d_model)
    mpos = _mrope_positions(B, S, P, 4)
    want, _ = jtransformer.forward(jmodel.cfg, jparams, jnp.asarray(toks),
                                   attn_impl="xla" if impl == "xla" else "chunked",
                                   patch_embeds=jnp.asarray(patches),
                                   mrope_positions=jnp.asarray(mpos))
    got, _ = transformer.forward(cfg, model.params, torch.from_numpy(toks), attn_impl=impl,
                                 patch_embeds=torch.from_numpy(patches),
                                 mrope_positions=torch.from_numpy(mpos))
    _close(got, want, 1e-4)
    # the prefix's tokens are replaced: other token ids there change nothing
    other = toks.copy()
    other[:, :P] = (other[:, :P] + 17) % cfg.vocab
    again, _ = transformer.forward(cfg, model.params, torch.from_numpy(other), attn_impl=impl,
                                   patch_embeds=torch.from_numpy(patches),
                                   mrope_positions=torch.from_numpy(mpos))
    assert torch.equal(again, got)
    # and the prefix and M-RoPE matter: without them the result differs
    bare, _ = transformer.forward(cfg, model.params, torch.from_numpy(toks), attn_impl=impl)
    assert float((bare - got).abs().max()) > 1e-2


def test_forward_bfloat16_with_patch_embeds_matches_reference():
    model, jmodel, jparams = _both(ARCH, dtype=torch.bfloat16)
    cfg = model.cfg
    toks, patches, mpos = _tokens(cfg, 2, 16), _patches(2, 8, cfg.d_model), \
        _mrope_positions(2, 16, 8, 4)
    want, _ = jtransformer.forward(jmodel.cfg, jparams, jnp.asarray(toks),
                                   patch_embeds=jnp.asarray(patches).astype(jnp.bfloat16),
                                   mrope_positions=jnp.asarray(mpos))
    got, _ = transformer.forward(cfg, model.params, torch.from_numpy(toks),
                                 patch_embeds=torch.from_numpy(patches).bfloat16(),
                                 mrope_positions=torch.from_numpy(mpos))
    assert got.dtype == torch.bfloat16
    _close(got, want, 5e-2)
    _close(model.logits(got), jmodel.logits(jparams, want), 5e-2)


@pytest.mark.parametrize("impl", ["chunked", "hopper"])
def test_vision_prefix_prefill_then_decode_matches_reference(impl):
    """``Model.prefill`` with the vision prefix, then decode steps with 1-D
    positions (plain RoPE at ``S``, as the reference decodes), on each side's
    own cache and on the reference's state carried across; the head is the
    tied embedding."""
    model, jmodel, jparams = _both(ARCH, attn_impl=impl)
    cfg = model.cfg
    assert cfg.tie_embeddings and "lm_head" not in model.state_dict()
    B, S, P = 2, 20, 8
    toks, patches = _tokens(cfg, B, S + 2), _patches(B, P, cfg.d_model)
    mpos = _mrope_positions(B, S, P, 4)
    jbatch = {"tokens": jnp.asarray(toks[:, :S]), "patch_embeds": jnp.asarray(patches),
              "mrope_positions": jnp.asarray(mpos)}
    batch = {"tokens": torch.from_numpy(toks[:, :S]), "patch_embeds": torch.from_numpy(patches),
             "mrope_positions": torch.from_numpy(mpos)}
    jh, jstate = jmodel.prefill(jparams, jbatch, S + 4)
    h, state = model.prefill(batch, S + 4)
    _close(h, jh, 1e-4)
    _close(model.logits(h[:, -1:]), jmodel.logits(jparams, jh[:, -1:]), 1e-4)
    _close(model.logits(h[:, -1:]), h[:, -1:] @ model.embed.T, 1e-6)
    assert state["pos"].tolist() == [S, S]
    carried = convert.state_from_reference(
        {"kv": tuple(_np(x) for x in jstate["kv"]), "pos": np.asarray(jstate["pos"])},
        device="cpu")
    for step in range(2):
        tok = toks[:, S + step:S + step + 1]
        jh, jstate = jmodel.decode_step(jparams, jnp.asarray(tok), jstate)
        h, state = model.decode_step(torch.from_numpy(tok), state)
        _close(h, jh, 2e-2)
        hc, carried = model.decode_step(torch.from_numpy(tok), carried)
        _close(hc, jh, 1e-4)
        _close(model.logits(hc), jmodel.logits(jparams, jh), 1e-4)
    assert carried["pos"].tolist() == [S + 2, S + 2]


def test_n_patches_and_config_match_the_reference():
    assert tqwen2_vl.N_PATCHES == jqwen2_vl.N_PATCHES == 256
    cfg = tqwen2_vl.CONFIG
    assert cfg.family == "vlm" and cfg.mrope and cfg.qkv_bias and cfg.moe is None
    assert transformer.param_shapes(cfg)["patch_proj"] == (1536, 1536)


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------


def test_server_matches_reference():
    """The five requests of the dense server test on reduced qwen2_vl_2b
    (tokens only, as the reference's server feeds them): its greedy token
    lists, logits within 1e-4 a step."""
    server, jserver = _servers(arch=ARCH)
    calls, jcalls = _record(server, False), _record(jserver, True)
    done = server.serve(_requests(Request))
    jdone = jserver.serve(_requests(JRequest))
    assert [c.uid for c in done] == [c.uid for c in jdone] == [0, 1, 2, 3, 4]
    compared, to_the_end = _compare_runs(calls, jcalls, done, jdone)
    assert compared >= 5 and to_the_end
    assert [c.tokens for c in done] == [c.tokens for c in jdone]
