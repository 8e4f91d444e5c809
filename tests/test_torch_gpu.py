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
from repro_torch.models import Model
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
