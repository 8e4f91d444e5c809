"""The port's tests that need a CUDA device (``pytest -m gpu``).

This file imports neither JAX nor the JAX package, so it runs on a machine
that has only the port's dependencies; on one without a card each test
skips.  Inputs are drawn with numpy from fixed seeds; each kernel is held
against its plain PyTorch version on the same tensors, the trainer against
itself, and the Server's captured decode step and prefills against its eager
loop.
``python3 chip_smoke.py`` runs the full sweep.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch.configs as tconfigs
from repro_torch.data import DataConfig
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import mamba2_ssd as ssd
from repro_torch.kernels import ops
from repro_torch.kernels import train_attention as ta
from repro_torch.models import Model, attention
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import Request, ServeConfig, Server, TrainConfig, Trainer

NO_CARD = "no CUDA device: the CUDA kernel has no interpret mode"


def _attention_inputs(B, Sq, Skv, Hq, Hkv, Dh, dtype, seed=0):
    """q, k, v and the positions of the newest ``Sq`` of ``Skv`` tokens, on the card."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, Hq, Dh), dtype=np.float32)
    k = rng.standard_normal((B, Skv, Hkv, Dh), dtype=np.float32)
    v = rng.standard_normal((B, Skv, Hkv, Dh), dtype=np.float32)
    qpos = np.broadcast_to(np.arange(Skv - Sq, Skv, dtype=np.int32)[None], (B, Sq)).copy()
    kpos = np.broadcast_to(np.arange(Skv, dtype=np.int32)[None], (B, Skv)).copy()
    return (*(torch.from_numpy(x).to(dtype).cuda() for x in (q, k, v)),
            torch.from_numpy(qpos).cuda(), torch.from_numpy(kpos).cuda())


def _ssd_inputs(B, S, H, P, N, dtype, seed=0):
    """x, dt (post-softplus), a (negative), bm, cm on the card, drawn as the
    reference's tests draw them."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, S, H, P)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    a = (-np.exp(rng.standard_normal(H) * 0.3)).astype(np.float32)
    bm = (rng.standard_normal((B, S, N)) * 0.4).astype(np.float32)
    cm = (rng.standard_normal((B, S, N)) * 0.4).astype(np.float32)
    x, dt, a, bm, cm = (torch.from_numpy(t).cuda() for t in (x, dt, a, bm, cm))
    return x.to(dtype), dt, a, bm.to(dtype), cm.to(dtype)


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               atol=tol, rtol=tol)


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_on_the_card():
    """float32 attention takes the fma path; held to the plain version at 2e-5."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    tq = _attention_inputs(2, 37, 300, 4, 2, 80, torch.float32)
    before = fa.flash_attention.launches
    got = ops.flash_attention(*tq)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    _close(got, fa.flash_attention_plain(*tq), 2e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("path,sq,groups", [("mma", 100, 1), ("split", 1, 4)])
def test_cuda_bf16_path_matches_plain_on_the_card(path, sq, groups):
    """bfloat16 prefill on mma, decode on split; held to the plain version at 2e-2."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    tq = _attention_inputs(2, sq, 300, 2 * groups, 2, 80, torch.bfloat16)
    before = dict(fa.flash_attention.launches_by_path)
    got = ops.flash_attention(*tq)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches_by_path[path] == before[path] + 1
    _close(got, fa.flash_attention_plain(*tq), 2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_ssd_kernel_matches_plain_on_the_card(dtype):
    """float32 takes the fma path, bfloat16 the mma path (y in float32, as the
    model asks: both paths keep near-fp32 products); held at 2e-4."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    args = _ssd_inputs(2, 100, 4, 32, 64, getattr(torch, dtype))
    path = "mma" if dtype == "bfloat16" else "fma"
    before = ssd.mamba2_ssd.launches_by_path[path]
    y, h = ops.mamba2_ssd(*args, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert ssd.mamba2_ssd.launches_by_path[path] == before + 1
    want_y, want_h = ssd.ssd_plain(*args, out_dtype=torch.float32)
    _close(y, want_y, 2e-4)
    _close(h, want_h, 2e-4)


@pytest.mark.gpu
def test_restart_is_bit_exact_on_the_card(tmp_path):
    """A failure at step 5 resumes from the step-4 checkpoint and ends with the
    uninterrupted run's loss and parameters, bit for bit (reduced stablelm)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    outs = []
    for name, injector in (("a", None), ("b", "fail")):
        armed = {"on": injector is not None}

        def fail(step):
            if step == 5 and armed["on"]:
                armed["on"] = False
                raise RuntimeError("injected node failure")

        cfg = tconfigs.reduced_config("stablelm_3b")
        tr = Trainer(cfg, AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=8),
                     TrainConfig(steps=8, checkpoint_every=4,
                                 checkpoint_dir=str(tmp_path / name)),
                     DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=4, seed=7))
        outs.append(tr.run(fault_injector=fail))
    assert outs[1]["restarts"] == 1 and outs[0]["losses"][-1] == outs[1]["losses"][-1]
    assert all(torch.equal(p, outs[1]["params"][k]) for k, p in outs[0]["params"].items())


@pytest.mark.gpu
def test_train_cli_with_fsdp_on_one_nccl_rank(tmp_path):
    """``python -m repro_torch.launch.train --smoke --fsdp``: one NCCL rank on
    a (data=1, model=1) mesh, 2 steps; rank 0's lines and its peak memory."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "stablelm_3b", "--smoke",
         "--steps", "2", "--seq-len", "64", "--global-batch", "4", "--fsdp",
         "--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "2"],
        cwd=root, env={**os.environ, "PYTHONPATH": os.path.join(root, "src")},
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["mesh"] == {"data": 1, "model": 1} and rec["fsdp"] is True
    assert len(rec["losses"]) == 2 and np.isfinite(rec["losses"]).all()
    assert rec["peak_memory_gb"] > 0


def _launches_by_path():
    return {"flash_attention": dict(fa.flash_attention.launches_by_path),
            "mamba2_ssd": dict(ssd.mamba2_ssd.launches_by_path)}


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["stablelm_3b", "zamba2_2_7b"])
def test_server_graph_matches_eager_on_the_card(arch):
    """Reduced bf16 models served with the decode step captured once as a CUDA
    graph and with the eager loop: the same tokens, and the same launches by
    path (every replay counted as the launches it ran).  Past the cache's
    end both raise the model's ``ValueError`` before the step."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    cfg = tconfigs.reduced_config(arch)
    weights = Model(cfg, device="cuda").init(seed=0).state_dict()
    rng = np.random.default_rng(0)
    requests = [Request(uid=i, prompt=rng.integers(1, cfg.vocab, size=n).astype(np.int32))
                for i, n in enumerate((5, 9, 17, 12, 7, 20))]
    scfg = ServeConfig(batch_slots=4, max_len=64, max_new_tokens=6, eos=-1)
    runs = {}
    for graph in (True, False):
        server = Server(cfg, scfg, weights, device="cuda", cuda_graph=graph)
        before = _launches_by_path()
        done = server.serve(requests)
        torch.cuda.synchronize()
        after = _launches_by_path()
        runs[graph] = ([c.tokens for c in done],
                       {k: {p: n - before[k][p] for p, n in v.items()} for k, v in after.items()})
        assert (server.graph is not None) == graph
    assert runs[True] == runs[False]
    assert runs[True][1]["flash_attention"]["split"] > 0
    for graph in (True, False):
        server = Server(cfg, ServeConfig(batch_slots=2, max_len=8, max_new_tokens=4, eos=-1),
                        weights, device="cuda", cuda_graph=graph)
        with pytest.raises(ValueError, match="KV cache of length 8 cannot take 1 token"):
            server.serve([Request(uid=0, prompt=np.arange(1, 7, dtype=np.int32))])


def _cloned(state):
    return {k: tuple(t.clone() for t in v) if isinstance(v, tuple) else v.clone()
            for k, v in state.items()}


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["stablelm_3b", "mamba2_370m"])
def test_server_prefill_graphs_match_eager_on_the_card(arch):
    """A Server on a reduced bf16 model serves prompts of 3 lengths twice:
    the first call captures one prefill graph a length, the second replays
    each, and every replayed prefill's logits and one-sequence state equal
    the eager Server's bit for bit, as do the tokens."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    cfg = tconfigs.reduced_config(arch)
    weights = Model(cfg, device="cuda").init(seed=0).state_dict()
    rng = np.random.default_rng(1)
    requests = [Request(uid=i, prompt=rng.integers(1, cfg.vocab, size=n).astype(np.int32))
                for i, n in enumerate((5, 12, 5, 30, 12, 30))]
    scfg = ServeConfig(batch_slots=2, max_len=64, max_new_tokens=4, eos=-1)
    runs = {}
    for graph in (True, False):
        server = Server(cfg, scfg, weights, device="cuda", cuda_graph=graph)
        server.serve(requests)
        seen, prefill = [], server._prefill

        def kept(tokens, prefill=prefill, seen=seen):
            logits, state = prefill(tokens)
            seen.append((logits.clone(), _cloned(state)))
            return logits, state

        server._prefill = kept
        done = server.serve(requests)
        torch.cuda.synchronize()
        runs[graph] = ([c.tokens for c in done], seen)
        # captured at a length's first prompt, replayed at the next three
        assert sorted(server.prefill_graphs) == ([5, 12, 30] if graph else [])
        assert all(g.replays == 3 for g in server.prefill_graphs.values())
    assert runs[True][0] == runs[False][0]
    assert len(runs[True][1]) == len(runs[False][1]) == len(requests)
    for (logits, state), (elogits, estate) in zip(runs[True][1], runs[False][1]):
        assert torch.equal(logits, elogits)
        for key, leaf in state.items():
            for a, b in zip(*((x if isinstance(x, tuple) else (x,)) for x in (leaf, estate[key]))):
                assert torch.equal(a, b), key


#: (B, S, Hq, Hkv, Dh, window, chunk): train_4k's shape, then GQA, a window, a chunk mask
TRAIN_ATTENTION_CASES = {
    "train_4k": (1, 4096, 32, 32, 80, None, None),
    "gqa4_dh128": (2, 300, 8, 2, 128, None, None),
    "window77_dh64": (2, 300, 4, 2, 64, 77, None),
    "chunk64_dh80": (1, 333, 4, 4, 80, None, 64),
}


#: the kernels' limits against the plain version (``chip_smoke.py``'s ``TRAIN_ATTN_GAP``
#: and ``TRAIN_ATTN_ROW_GAP``): the whole tensor's gap, and the worst query row's or key's
TRAIN_ATTENTION_GAP = 0.005
TRAIN_ATTENTION_ROW_GAP = 0.017


def _row_gap(got, want):
    """``(worst, whole)``: the worst row's ``|got - want| / |want|`` over the
    head width (a query row's or a key's vector), each norm at least a tenth of
    the rows' RMS norm, and the whole tensor's; NaN where ``got`` is not finite."""
    diff = (got.float() - want.float()).norm(dim=-1)
    ref = want.float().norm(dim=-1)
    worst = (diff / ref.clamp_min(0.1 * float(ref.square().mean().sqrt()))).max()
    return float(worst), float(diff.norm() / ref.norm())


def _fp8_rows(x):
    """``x`` rounded to float8 e4m3, one scale a row (its largest magnitude at 448)."""
    scale = 448.0 / x.abs().amax(-1, keepdim=True).clamp_min(1e-30)
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


def _plain_train_attention(q, k, v, do, qpos, kpos, window, chunk):
    """The plain version's ``(out, dq, dk, dv)``."""
    out, lse = ta.train_attention_plain_forward(q, k, v, qpos, kpos, window, chunk)
    return (out, *ta.train_attention_plain_backward(q, k, v, out, lse, do, qpos, kpos,
                                                    window, chunk))


def _train_inputs(B, S, Hq, Hkv, Dh, seed=0):
    q, k, v, qpos, kpos = _attention_inputs(B, S, S, Hq, Hkv, Dh, torch.bfloat16, seed)
    rng = np.random.default_rng(seed + 1)
    do = torch.from_numpy(rng.standard_normal((B, S, Hq, Dh), dtype=np.float32)).bfloat16().cuda()
    return q, k, v, do, qpos, kpos


@pytest.mark.gpu
@pytest.mark.parametrize("case", TRAIN_ATTENTION_CASES)
def test_train_attention_kernels_match_plain_on_the_card(case):
    """The autograd function's forward and backward kernels against the plain
    version's: in each of out, dq, dk and dv the whole tensor's gap under
    ``TRAIN_ATTENTION_GAP`` and every query row's or key's under
    ``TRAIN_ATTENTION_ROW_GAP``."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    B, S, Hq, Hkv, Dh, window, chunk = TRAIN_ATTENTION_CASES[case]
    q, k, v, do, qpos, kpos = _train_inputs(B, S, Hq, Hkv, Dh)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = dict(ta.train_attention.launches_by_kernel)
    out = ta.train_attention(*leaves, qpos, kpos, window, chunk)
    got = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    assert all(ta.train_attention.launches_by_kernel[n] == before[n] + 1 for n in ta.KERNELS)
    want = _plain_train_attention(q, k, v, do, qpos, kpos, window, chunk)
    gaps = [_row_gap(g, w) for g, w in zip((out.detach(), *got), want)]
    assert max(whole for _, whole in gaps) <= TRAIN_ATTENTION_GAP, gaps
    assert max(row for row, _ in gaps) <= TRAIN_ATTENTION_ROW_GAP, gaps


@pytest.mark.gpu
@pytest.mark.parametrize("case", TRAIN_ATTENTION_CASES)
def test_train_attention_gap_refuses_a_float8_control_on_the_card(case, monkeypatch):
    """The plain version with P and dS rounded to float8 (one precision below
    bfloat16) is further from the plain version than both limits, in each of
    out, dq, dk and dv: the limits tell the precision apart."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    B, S, Hq, Hkv, Dh, window, chunk = TRAIN_ATTENTION_CASES[case]
    q, k, v, do, qpos, kpos = _train_inputs(B, S, Hq, Hkv, Dh)
    want = _plain_train_attention(q, k, v, do, qpos, kpos, window, chunk)
    monkeypatch.setattr(ta, "_rounder", lambda dtype: _fp8_rows)
    control = _plain_train_attention(q, k, v, do, qpos, kpos, window, chunk)
    gaps = [_row_gap(c, w) for c, w in zip(control, want)]
    assert min(whole for _, whole in gaps) > TRAIN_ATTENTION_GAP, gaps
    assert min(row for row, _ in gaps) > TRAIN_ATTENTION_ROW_GAP, gaps


@pytest.mark.gpu
def test_train_attention_backward_is_bit_exact_on_the_card():
    """Two backward runs on the same inputs give the same gradients bit for
    bit (no atomics: every sum in one block, in a fixed order)."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    q, k, v, do, qpos, kpos = _train_inputs(2, 700, 16, 4, 80, seed=3)
    out, lse = ta.train_attention_forward(q, k, v, qpos, kpos)
    first = ta.train_attention_backward(q, k, v, out, lse, do, qpos, kpos)
    second = ta.train_attention_backward(q, k, v, out, lse, do, qpos, kpos)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def _leaf_gap(got, want):
    """The worst leaf's gradient gap: its distance over the larger of its own
    reference norm and the median leaf's (as the benchmark's check reads it)."""
    norms = {k: float(w.float().norm()) for k, w in want.items()}
    med = float(np.median(list(norms.values())))
    return max(float((got[k].float() - want[k].float()).norm()) / max(norms[k], med)
               for k in want)


#: the 2-layer step's limit: the worst leaf's gradient gap to a float32 copy of the
#: weights through the kernels over the same gap through the loop.  Two bf16 steps of the
#: model differ by about 0.012 whatever attention they take, the loop's own gap to float32,
#: so the kernels are held to the loop's gap and not to a fixed one
TRAIN_STEP_GAP_RATIO = 1.25


def _model_step_gaps(control=False, seed=0):
    """stablelm_3b's widths, 2 layers, ``remat="full"``: the worst leaf's
    gradient gap (``_leaf_gap``) of a bf16 step whose chunked attention runs on
    the kernels, and of the same step through the loop, each against the same
    weights in float32 through the loop; and the kernels' launches.
    ``control`` swaps the kernels for the plain version with P and dS rounded
    to float8."""
    from unittest import mock

    cfg = dataclasses.replace(tconfigs.get_config("stablelm_3b"), n_layers=2)
    model = Model(cfg, attn_impl="chunked", device="cuda", remat="full").init(seed=seed)
    ref = Model(dataclasses.replace(cfg, dtype=torch.float32), attn_impl="chunked",
                device="cuda", remat="full")
    params, ref_params = dict(model.named_parameters()), dict(ref.named_parameters())
    with torch.no_grad():
        for name, p in ref_params.items():
            p.copy_(params[name].float())
    for p in (*params.values(), *ref_params.values()):
        p.requires_grad_(True)
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, size=(2, 1024))).cuda()
    batch = {"tokens": tokens, "targets": torch.roll(tokens, -1, 1)}

    def grads(m, ps):
        loss = m.train_loss(batch)
        return dict(zip(ps, torch.autograd.grad(loss, list(ps.values()))))

    want = grads(ref, ref_params)
    before = dict(ta.train_attention.launches_by_kernel)
    swap = (mock.patch.multiple(ta, train_attention_forward=ta.train_attention_plain_forward,
                                train_attention_backward=ta.train_attention_plain_backward,
                                _rounder=lambda dtype: _fp8_rows)
            if control else contextlib.nullcontext())
    with swap:
        got = grads(model, params)
    torch.cuda.synchronize()
    launched = {n: ta.train_attention.launches_by_kernel[n] - before[n] for n in ta.KERNELS}
    with mock.patch.object(attention, "takes_train_kernel", lambda *a: False):
        loop = grads(model, params)
    return _leaf_gap(got, want), _leaf_gap(loop, want), launched


@pytest.mark.gpu
def test_model_step_through_the_train_attention_kernels_on_the_card():
    """A step whose chunked attention runs on the kernels (two forwards and one
    backward a layer) is as close to float32 as the same step through the loop:
    its worst leaf's gap at most ``TRAIN_STEP_GAP_RATIO`` times the loop's."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    kernel, loop, launched = _model_step_gaps()
    assert launched == {"fwd": 4, "bwd_dot": 2, "bwd_dkdv": 2, "bwd_dq": 2}
    assert kernel <= TRAIN_STEP_GAP_RATIO * loop, (kernel, loop)


@pytest.mark.gpu
def test_model_step_gap_refuses_a_float8_control_on_the_card():
    """The same step with P and dS rounded to float8 (the plain version in the
    kernels' place) is further from float32 than ``TRAIN_STEP_GAP_RATIO`` times
    the loop's gap: the limit tells the precision apart."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    control, loop, launched = _model_step_gaps(control=True)
    assert not any(launched.values())
    assert control > TRAIN_STEP_GAP_RATIO * loop, (control, loop)


@pytest.mark.gpu
def test_stacked_leaves_grads_are_the_per_layer_selects_on_the_card(tmp_path):
    """One ``Trainer.step`` at stablelm_3b's widths, 2 layers: with each stacked
    leaf unbound once a forward, the loss, the gradients and the stepped
    parameters are the per-layer ``w[i]``'s bit for bit, and no bf16 fill of a
    whole stacked leaf runs, where the per-layer selects run some."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    import chip_smoke

    got = chip_smoke.stacked_grads_check(str(tmp_path))
    assert got["loss_equal"] and got["grads_bit_equal"] and got["params_bit_equal"], got
    assert got["stacked_bf16_fills"]["unbind"] == 0 < got["stacked_bf16_fills"]["select"], got


# ---------------------------------------------------------------------------
# Zamba2-7B's shapes: two B / C groups, heads of 224 with their own scale
# ---------------------------------------------------------------------------

#: (H, P, N, G) of Zamba2-7B's mamba layers
ZAMBA2_7B_SSD = (112, 64, 64, 2)


def _norm_gap(got, want):
    """The relative norm of the difference: what a float8 control must fail."""
    return float((got.float() - want.float()).norm() / want.float().norm())


def _fp8(t):
    return t.to(torch.float8_e4m3fn).to(t.dtype)


def _grouped_ssd(S, H, P, N, G, seed=0):
    """bf16 x, B and C cut from one ``(1, S, H P + 2 G N)`` tensor as the
    model cuts them (B / C ``(1, S, G, N)`` views), fp32 dt and ``a``."""
    rng = np.random.default_rng(seed)
    xbc = torch.from_numpy(rng.standard_normal((1, S, H * P + 2 * G * N), dtype=np.float32)
                           * 0.5).cuda().bfloat16()
    x = xbc[..., :H * P].reshape(1, S, H, P)
    bm = xbc[..., H * P:H * P + G * N].unflatten(-1, (G, N))
    cm = xbc[..., H * P + G * N:].unflatten(-1, (G, N))
    dt = torch.nn.functional.softplus(torch.from_numpy(
        rng.standard_normal((1, S, H), dtype=np.float32)).cuda())
    a = -torch.linspace(1.0, 16.0, H, device="cuda")
    return x, dt, a, bm, cm


@pytest.mark.gpu
@pytest.mark.parametrize("S", [300, 2048])
def test_ssd_kernel_takes_two_groups_on_the_card(S):
    """Zamba2-7B's layer at G = 2, one launch: against ``ssd_plain`` by the
    norm gap (1e-3: the mma path keeps near-fp32 products; x rounded to
    float8 fails it), and bit for bit against the kernel fed each head's
    group expanded (G = H: the same blocks, the same arithmetic)."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    H, P, N, G = ZAMBA2_7B_SSD
    x, dt, a, bm, cm = _grouped_ssd(S, H, P, N, G, seed=S)
    before = ssd.mamba2_ssd.launches_by_path["mma"]
    y, h = ops.mamba2_ssd(x, dt, a, bm, cm, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert ssd.mamba2_ssd.launches_by_path["mma"] == before + 1
    want_y, want_h = ssd.ssd_plain(x, dt, a, bm, cm, out_dtype=torch.float32)
    assert _norm_gap(y, want_y) < 1e-3 and _norm_gap(h, want_h) < 1e-3
    ctrl_y, _ = ssd.ssd_plain(_fp8(x), dt, a, bm, cm, out_dtype=torch.float32)
    assert _norm_gap(ctrl_y, want_y) > 1e-3
    wide = [t.repeat_interleave(H // G, dim=2) for t in (bm, cm)]
    y_h, h_h = ops.mamba2_ssd(x, dt, a, *wide, out_dtype=torch.float32)
    assert torch.equal(y, y_h) and torch.equal(h, h_h)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(32, 64, 128), (80, 64, 64)])
def test_ssd_kernel_one_group_axis_is_the_old_call_on_the_card(shape):
    """mamba2_370m's and zamba2_2_7b's prefill (512 tokens): B / C as
    ``(B, S, N)`` and as ``(B, S, 1, N)`` give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    H, P, N = shape
    x, dt, a, bm, cm = _grouped_ssd(512, H, P, N, 1)
    flat = ops.mamba2_ssd(x, dt, a, bm[:, :, 0], cm[:, :, 0], out_dtype=torch.float32)
    axis = ops.mamba2_ssd(x, dt, a, bm, cm, out_dtype=torch.float32)
    assert all(torch.equal(p, q) for p, q in zip(flat, axis))


def test_choose_plan_at_zamba2_7b():
    """One prompt of Zamba2-7B's layer: the mma path, 32 state rows a block,
    224 blocks in one wave of two a block an SM (the table's registers)."""
    H, P, N, _ = ZAMBA2_7B_SSD
    plan = ssd.choose_plan(1, H, P, N, torch.bfloat16)
    assert (plan.path, plan.p_block, plan.blocks, plan.waves) == ("mma", 32, 224, 1)


@pytest.mark.gpu
@pytest.mark.parametrize("path", ["mma", "split"])
def test_attention_at_head_width_224_with_its_scale_on_the_card(path):
    """Zamba2-7B's shared-block attention, Dh 224 (the Dh-256 class) with the
    scale ``(224 / 2) ** -0.5``: a 2,000-token prompt on ``mma``, a decode
    row a slot of 24 slots against a 4,096-key cache on ``split``; against
    the plain version of the same path by the norm gap (1e-2: bf16 output of
    the same online softmax; q rounded to float8 fails it)."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    scale = (224 / 2) ** -0.5
    if path == "mma":
        q, k, v, qpos, kpos = _attention_inputs(1, 2000, 2000, 32, 32, 224, torch.bfloat16)
    else:
        q, k, v, qpos, kpos = _attention_inputs(24, 1, 4096, 32, 32, 224, torch.bfloat16)
        qpos = torch.arange(1000, 1000 + 24 * 120, 120, dtype=torch.int32,
                            device="cuda")[:, None]
    before = dict(fa.flash_attention.launches_by_path)
    got = ops.flash_attention(q, k, v, qpos, kpos, scale=scale)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches_by_path[path] == before[path] + 1
    want = fa.flash_attention_plain(q, k, v, qpos, kpos, scale=scale)
    unscaled = fa.flash_attention_plain(q, k, v, qpos, kpos)
    assert _norm_gap(got, want) < 1e-2 < _norm_gap(unscaled, want)
    ctrl = fa.flash_attention_plain(_fp8(q), k, v, qpos, kpos, scale=scale)
    assert _norm_gap(ctrl, want) > 1e-2
