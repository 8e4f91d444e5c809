#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py                 # every phase; needs one CUDA device
    python3 chip_smoke.py --phases device,build,kernel_vs_plain

It imports ``repro_torch`` only, builds the CUDA kernels from
``src/repro_torch/kernels/csrc/`` with ``nvcc``, and drives the port's main
path through the entry points a user calls.  Each phase prints one JSON line:

1. ``device``            card name and power limit (``nvidia-smi``), torch / CUDA / nvcc versions
2. ``build``             build seconds, the ``.so``, per-kernel registers / spills from ptxas
3. ``kernel_vs_plain``   the attention kernel against its plain PyTorch version and the
                         oracle over shapes, dtypes, masks and ragged lengths
                         (tolerance 2e-5 in fp32, 2e-2 in bf16, absolute + relative)
4. ``serve``             ``Server.serve`` on full-width stablelm_3b (32 layers, bf16, random
                         weights from a seed): 16 requests through 8 slots; every attention
                         call must have gone through the kernel (launch count); logits are
                         re-derived through the chunked PyTorch path and compared
5. ``kernels``           one line ``{"kernels": [...]}``: launches on the main path, error
                         against the plain version, time, plain time, library time
                         (``scaled_dot_product_attention``, a yardstick the port never
                         calls) and the card's bound, at the two shapes the main path uses
6. ``serve_throughput``  tokens/s and completion latencies, with the card's name and limit

``--phases serve,profile`` adds a ``torch.profiler`` pass over a few decode steps
(device time by kernel, device busy share); it is not part of the default run.

Any failed phase ends the run with a non-zero exit code; there is no CPU
fallback.  The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import os
import re
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.runtime import Request, ServeConfig, Server  # noqa: E402

PHASES = ["device", "build", "kernel_vs_plain", "serve", "kernels", "serve_throughput"]
EXTRA_PHASES = ["profile"]   # not run by default: python3 chip_smoke.py --phases serve,profile
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# published peaks of one H100 SXM (NVIDIA data sheet): device memory rate and
# dense bf16 tensor-core rate; the bound is stated against these
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
KERNEL_REPLACES = "src/repro/kernels/flash_attention.py:86"


class SmokeFailure(RuntimeError):
    """A phase found something wrong; the run ends with a non-zero exit code."""


def require(cond, message: str) -> None:
    # not `assert`: the checks must hold under `python -O` too
    if not cond:
        raise SmokeFailure(message)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def run_text(cmd) -> str:
    return subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                          check=True).stdout.strip()


# ---------------------------------------------------------------------------
# inputs and comparisons
# ---------------------------------------------------------------------------


def make_case(B, Sq, Skv, Hq, Hkv, Dh, dtype, seed=0, q_positions=None):
    """Inputs from a seeded numpy generator, on the card; the query block sits
    at the end of the kv range unless ``q_positions`` says otherwise."""
    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")

    def t(shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev).to(dtype)

    q, k, v = t((B, Sq, Hq, Dh)), t((B, Skv, Hkv, Dh)), t((B, Skv, Hkv, Dh))
    if q_positions is None:
        qpos = torch.arange(Skv - Sq, Skv, dtype=torch.int32, device=dev)[None].expand(B, Sq)
    else:
        qpos = torch.as_tensor(q_positions, dtype=torch.int32, device=dev)
    kpos = torch.arange(Skv, dtype=torch.int32, device=dev)[None].expand(B, Skv)
    return q, k, v, qpos, kpos


def misaligned(t):
    """A copy of ``t`` that starts one element past a 16-byte boundary, so the
    kernel must take its element-by-element loads."""
    buf = torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)
    view = buf[1:1 + t.numel()].view(t.shape)
    view.copy_(t)
    return view


def oracle(q, k, v, qpos, kpos, window=None, chunk=None):
    """``ref.attention_reference`` in the model layout (heads flattened and K / V
    repeated per group, as the reference's tests do)."""
    B, Sq, Hq, Dh = q.shape
    g = Hq // k.shape[2]
    qf = q.permute(0, 2, 1, 3).reshape(B * Hq, Sq, Dh)
    kf = k.permute(0, 2, 1, 3).repeat_interleave(g, 1).reshape(B * Hq, -1, Dh)
    vf = v.permute(0, 2, 1, 3).repeat_interleave(g, 1).reshape(B * Hq, -1, Dh)
    out = ref.attention_reference(
        qf, kf, vf, qpos.repeat_interleave(Hq, 0), kpos.repeat_interleave(Hq, 0), window, chunk
    )
    return out.reshape(B, Hq, Sq, Dh).permute(0, 2, 1, 3)


def compare(got, want, tol):
    got, want = got.float(), want.float()
    err = (got - want).abs()
    ok = bool((err <= tol + tol * want.abs()).all()) and bool(torch.isfinite(got).all())
    return float(err.max()), ok


def check_case(name, args, dtype, failures, results, **kw):
    q, k, v, qpos, kpos = args
    before = fa.flash_attention.launches
    got = ops.flash_attention(q, k, v, qpos, kpos, **kw)
    torch.cuda.synchronize()
    require(fa.flash_attention.launches == before + 1, "the wrapper did not launch the kernel")
    plain_kw = dict(window=kw.get("window"), chunk=kw.get("chunk_attn"),
                    block_q=kw.get("block_q"), block_kv=kw.get("block_kv"))
    plain = fa.flash_attention_plain(q, k, v, qpos, kpos, **plain_kw)
    want = oracle(q, k, v, qpos, kpos, kw.get("window"), kw.get("chunk_attn"))
    torch.cuda.synchronize()
    err_plain, ok_plain = compare(got, plain, TOL[dtype])
    err_oracle, ok_oracle = compare(got, want, TOL[dtype])
    results.append({"case": name, "dtype": str(dtype).replace("torch.", ""),
                    "err_vs_plain": err_plain, "err_vs_oracle": err_oracle,
                    "ok": ok_plain and ok_oracle})
    if not (ok_plain and ok_oracle):
        failures.append(name)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device(ctx):
    smi = run_text(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    ctx["card"] = smi.splitlines()[0].strip()
    nvcc = run_text([_build.find_nvcc(), "--version"]).splitlines()[-2:]
    emit("device", card=ctx["card"], kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__, cuda=torch.version.cuda,
         driver=run_text(["nvidia-smi", "--query-gpu=driver_version",
                          "--format=csv,noheader"]).splitlines()[0],
         python=sys.version.split()[0], nvcc=" | ".join(s.strip() for s in nvcc))


_MANGLED = re.compile(r"flash_attention_kernelI(f|13__nv_bfloat16)Li(\d+)ELi(\d+)ELi(\d+)E")


def readable(mangled: str) -> str:
    """``flash_attention_kernel<T, NJ, RM, NKJ>`` as dtype, head-width class and tile."""
    m = _MANGLED.search(mangled)
    if not m:
        return mangled
    t, nj, rm, nkj = m.group(1), int(m.group(2)), int(m.group(3)), int(m.group(4))
    return (f"flash_attention<{'float' if t == 'f' else 'bf16'}, Dh<={16 * nj}, "
            f"BQ={16 * rm}, BKV={16 * nkj}>")


def phase_build(ctx):
    t0 = time.perf_counter()
    info = _build.info()
    res = [{**r, "kernel": readable(r["kernel"])} for r in info.resources()]
    require(res, "ptxas reported no kernel")
    ctx["resources"] = {r["kernel"]: r for r in res}
    emit("build", seconds=round(info.seconds or time.perf_counter() - t0, 3), reused=info.reused,
         so=os.path.relpath(info.path), kernels=len(res),
         max_registers=max(r["registers"] for r in res),
         spill_bytes=sum(r["spill_store_bytes"] + r["spill_load_bytes"] for r in res),
         resources=res)
    # the chooser's shared-memory formula is the kernel's own
    lib = _build.load()
    lib.repro_flash_attention_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.repro_flash_attention_smem_bytes.restype = ctypes.c_longlong
    for dh in (16, 80, 128, 256):
        for bq in fa.TILE_Q:
            for bkv in fa.TILE_KV:
                require(lib.repro_flash_attention_smem_bytes(dh, bq, bkv)
                        == fa.smem_bytes(dh, bq, bkv),
                        f"shared-memory formulas differ at Dh={dh}, tile ({bq}, {bkv})")


ATTN_SHAPES = [
    # (B, Sq, Skv, Hq, Hkv, Dh): the shape sweep of the reference's kernel tests
    (1, 128, 128, 2, 2, 64),
    (2, 128, 128, 4, 1, 64),
    (2, 64, 256, 4, 2, 128),
    (1, 256, 256, 8, 4, 128),
    (2, 128, 128, 4, 4, 256),
]


def phase_kernel_vs_plain(ctx):
    failures, results = [], []
    f32, bf16 = torch.float32, torch.bfloat16
    for shape in ATTN_SHAPES:
        for dtype in (f32, bf16):
            check_case(f"shape{shape}", make_case(*shape, dtype), dtype, failures, results,
                       block_q=64, block_kv=64)
    for window in (16, 64):
        check_case(f"window{window}", make_case(2, 128, 128, 4, 2, 64, f32), f32, failures,
                   results, window=window, block_q=64, block_kv=64)
    for chunk in (32, 64):
        check_case(f"chunk{chunk}", make_case(2, 128, 128, 4, 2, 64, f32), f32, failures,
                   results, chunk_attn=chunk, block_q=64, block_kv=64)
    for bq, bkv in ((16, 32), (16, 64), (64, 32), (64, 64)):
        check_case(f"tile({bq},{bkv})", make_case(1, 128, 128, 2, 2, 64, f32), f32, failures,
                   results, block_q=bq, block_kv=bkv)
    for sq, skv in ((1, 512), (7, 19), (100, 300), (37, 1024)):
        for dtype in (f32, bf16):
            check_case(f"ragged({sq},{skv})", make_case(2, sq, skv, 4, 2, 64, dtype), dtype,
                       failures, results)
    check_case("ragged+window32", make_case(2, 100, 100, 4, 2, 64, f32), f32, failures, results,
               window=32)
    check_case("ragged+chunk64", make_case(1, 200, 200, 2, 2, 64, f32), f32, failures, results,
               chunk_attn=64)
    check_case("unrestricted=BIG", make_case(1, 129, 257, 2, 1, 128, f32), f32, failures, results,
               window=fa.BIG, chunk_attn=fa.BIG)
    for dh in (16, 48, 96, 112, 160, 256):
        check_case(f"dh{dh}", make_case(1, 70, 150, 4, 2, dh, f32), f32, failures, results)
    # stablelm_3b's heads at the two shapes of the main path
    for dtype in (f32, bf16):
        check_case("dh80 prefill", make_case(1, 512, 1024, 32, 32, 80, dtype), dtype, failures,
                   results)
        check_case("dh80 decode", make_case(8, 1, 1024, 32, 32, 80, dtype), dtype, failures,
                   results)
    # decode with unequal slot lengths: one query row a slot, each at its own position
    lengths = np.random.default_rng(1).integers(1, 1024, size=(8, 1))
    for dtype in (f32, bf16):
        check_case("decode unequal positions",
                   make_case(8, 1, 1024, 32, 32, 80, dtype, q_positions=lengths), dtype,
                   failures, results)
    # every key masked (query positions before the first key): the mean of the v rows
    check_case("all keys masked", make_case(1, 5, 70, 2, 2, 64, f32,
                                            q_positions=np.full((1, 5), -3)), f32,
               failures, results)
    # strided operands: a window of a longer cache and every other head, no copy
    q, k, v, qpos, kpos = make_case(2, 33, 300, 8, 4, 64, bf16)
    check_case("strided views", (q[:, :, ::2], k[:, 40:240, ::2], v[:, 40:240, ::2], qpos,
                                 kpos[:, 40:240]), bf16, failures, results)
    # operands that do not start on a 16-byte boundary: the scalar loads
    for dtype in (f32, bf16):
        q, k, v, qpos, kpos = make_case(2, 37, 300, 4, 2, 80, dtype)
        check_case("misaligned operands", (misaligned(q), misaligned(k), misaligned(v), qpos,
                                           kpos), dtype, failures, results)
    emit("kernel_vs_plain", cases=len(results), failed=failures,
         max_err_fp32=max(r["err_vs_oracle"] for r in results if r["dtype"] == "float32"),
         max_err_bf16=max(r["err_vs_oracle"] for r in results if r["dtype"] == "bfloat16"),
         tolerance={"float32": 2e-5, "bfloat16": 2e-2}, results=results)
    require(not failures, f"kernel disagrees on: {failures}")

    # what the wrapper must refuse rather than hand to the plain version
    q, k, v, qpos, kpos = make_case(1, 8, 8, 2, 2, 64, f32)
    for bad, exc in (
        (lambda: ops.flash_attention(q[..., :24], k[..., :24], v[..., :24], qpos, kpos), ValueError),
        (lambda: ops.flash_attention(q.half(), k.half(), v.half(), qpos, kpos), TypeError),
        (lambda: ops.flash_attention(q, k.bfloat16(), v.bfloat16(), qpos, kpos), TypeError),
        (lambda: ops.flash_attention(q.transpose(2, 3).contiguous().transpose(2, 3), k, v,
                                     qpos, kpos), ValueError),
        (lambda: ops.flash_attention(q.requires_grad_(), k, v, qpos, kpos), RuntimeError),
    ):
        before = fa.flash_attention.launches
        try:
            bad()
        except exc:
            require(fa.flash_attention.launches == before, "a refused input counted as a launch")
        else:
            raise SmokeFailure("the wrapper took an input the kernel does not take")


SERVE = dict(batch_slots=8, max_len=1024, max_new_tokens=32, n_requests=16, seed=0)


def phase_serve(ctx):
    cfg = get_config("stablelm_3b")
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    model = Model(cfg, device=dev).init(seed=SERVE["seed"])
    scfg = ServeConfig(batch_slots=SERVE["batch_slots"], max_len=SERVE["max_len"],
                       max_new_tokens=SERVE["max_new_tokens"], eos=-1)
    server = Server(cfg, scfg, model.state_dict(), device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in server.model.parameters())

    rng = np.random.default_rng(SERVE["seed"])
    lengths = rng.integers(64, 513, size=SERVE["n_requests"])
    requests = [Request(uid=i, prompt=rng.integers(0, cfg.vocab, size=int(n)).astype(np.int32))
                for i, n in enumerate(lengths)]

    # warm-up outside the measured run: one short request through a second
    # server on the same weights (library handles, allocator, first launches)
    warm = Server(cfg, dataclasses.replace(scfg, max_new_tokens=3), model.state_dict(), device=dev)
    warm.serve([Request(uid=-1, prompt=requests[0].prompt[:64])])
    torch.cuda.synchronize()

    # count and time forward passes by wrapping the two step functions of the
    # server; the synchronise is the one sampling makes anyway right after
    steps = {"prefill": 0, "decode": 0}
    step_ms = {"prefill": [], "decode": []}
    nan_seen = []

    def counted(fn, key):
        def wrapper(*args):
            steps[key] += 1
            t = time.perf_counter()
            logits, state = fn(*args)
            torch.cuda.synchronize()
            step_ms[key].append((time.perf_counter() - t) * 1e3)
            nan_seen.append(torch.isnan(logits).any())
            return logits, state
        return wrapper

    server._prefill = counted(server._prefill, "prefill")
    server._decode = counted(server._decode, "decode")

    torch.cuda.reset_peak_memory_stats()
    fa.flash_attention.launches = 0           # the main path starts here
    t0 = time.perf_counter()
    done = server.serve(requests)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = fa.flash_attention.launches   # ... and ends here
    ctx["launches"] = launches
    ctx["server"] = server

    require([c.uid for c in done] == list(range(SERVE["n_requests"])), "completions out of order")
    require(all(len(c.tokens) == SERVE["max_new_tokens"] for c in done), "a completion is short")
    require(all(0 <= t < cfg.vocab for c in done for t in c.tokens), "a token outside the vocabulary")
    require(not bool(torch.stack(nan_seen).any()), "NaN in the logits")
    forwards = steps["prefill"] + steps["decode"]
    require(steps["prefill"] == SERVE["n_requests"], "not one prefill a request")
    require(launches == cfg.n_layers * forwards, (
        f"{launches} kernel launches for {forwards} forward passes of {cfg.n_layers} layers: "
        "an attention call went around the kernel"))

    # the same logits through the chunked PyTorch path, on the card
    model_k = server.model
    tokens = torch.from_numpy(requests[0].prompt[None]).to(dev)

    def logits_of(impl):
        model_k.attn_impl = impl
        try:
            h, state = model_k.prefill({"tokens": tokens}, scfg.max_len)
            pre = model_k.logits(h[:, -1:])[:, 0].float()
            h, state = model_k.decode_step(pre.argmax(-1, keepdim=True), state)
            return pre, model_k.logits(h[:, -1:])[:, 0].float()
        finally:
            model_k.attn_impl = "hopper"

    pre_k, dec_k = logits_of("hopper")
    pre_c, dec_c = logits_of("chunked")
    torch.cuda.synchronize()
    # bf16 through 32 layers: logits of magnitude ~4 are spaced 0.03 apart and the
    # two paths round each layer's attention output on their own, so one to two
    # spacings of difference are expected; 1e-1 (absolute + relative) allows three
    tol = 1e-1
    err_pre, ok_pre = compare(pre_k, pre_c, tol)
    err_dec, ok_dec = compare(dec_k, dec_c, tol)
    emit("serve", model=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model, heads=cfg.n_heads,
         head_dim=cfg.dh, d_ff=cfg.d_ff, vocab=cfg.vocab, dtype="bfloat16", params=n_params,
         init_seconds=round(init_s, 3), serve_seconds=round(serve_s, 3),
         requests=len(done), prompt_lengths=[int(n) for n in lengths],
         tokens=sum(len(c.tokens) for c in done), prefills=steps["prefill"],
         decode_steps=steps["decode"], kernel_launches=launches,
         prefill_ms_mean=round(float(np.mean(step_ms["prefill"])), 3),
         decode_step_ms_mean=round(float(np.mean(step_ms["decode"])), 3),
         decode_step_ms_p50=round(float(np.median(step_ms["decode"])), 3),
         decode_step_ms_min=round(float(np.min(step_ms["decode"])), 3),
         decode_step_ms_all=[round(t, 1) for t in step_ms["decode"]],
         peak_memory_gb=round(torch.cuda.max_memory_allocated() / 2**30, 3),
         prefill_logits_err_vs_chunked=err_pre, decode_logits_err_vs_chunked=err_dec,
         argmax_agrees=[bool((pre_k.argmax(-1) == pre_c.argmax(-1)).all()),
                        bool((dec_k.argmax(-1) == dec_c.argmax(-1)).all())],
         tolerance=tol, first_completion=done[0].tokens[:8])
    require(ok_pre and ok_dec, "kernel path and chunked path disagree on the logits")


def time_ms(fn, warmup=3, iters=20):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def bound(q, k, v, qpos, kpos):
    """Least time the card could take: every input read once and the output
    written once at the memory rate, or the two products' operations
    (no causal discount: positions are data) at the bf16 tensor-core rate."""
    B, Sq, Hq, Dh = q.shape
    Skv = k.shape[1]
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v)) + q.numel() * q.element_size()
    nbytes += 4 * (B * Sq + B * Skv)
    flops = 4 * B * Hq * Sq * Skv * Dh
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_BF16_FLOPS * 1e3
    return {"bytes": nbytes, "flops": flops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def phase_kernels(ctx):
    shapes = {"prefill": (1, 512, 1024, 32, 32, 80), "decode": (8, 1, 1024, 32, 32, 80)}
    rows = {}
    for name, shape in shapes.items():
        q, k, v, qpos, kpos = make_case(*shape, torch.bfloat16)
        if name == "decode":   # the query is the newest token of a full cache
            qpos = torch.full((shape[0], 1), shape[2] - 1, dtype=torch.int32, device=q.device)
        got = ops.flash_attention(q, k, v, qpos, kpos)
        plain = fa.flash_attention_plain(q, k, v, qpos, kpos)
        err, ok = compare(got, plain, TOL[torch.bfloat16])
        require(ok, f"kernel disagrees with its plain version at the {name} shape")
        mask = ref.attention_mask(qpos[:, None, :, None], kpos[:, None, None, :])
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib = sdpa(qt, kt, vt, attn_mask=mask).transpose(1, 2)
        err_lib, _ = compare(got, lib, TOL[torch.bfloat16])
        # the same kernel on copies that are not 16-byte aligned: its scalar loads
        qm, km, vm = misaligned(q), misaligned(k), misaligned(v)
        err_m, ok = compare(ops.flash_attention(qm, km, vm, qpos, kpos), got, 0.0)
        require(ok, f"scalar and 16-byte loads disagree at the {name} shape ({err_m})")
        # in turns: plain, scalar, kernel, kernel, scalar, plain; the library call last
        t_plain = [time_ms(lambda: fa.flash_attention_plain(q, k, v, qpos, kpos), 1, 5)]
        t_scalar = [time_ms(lambda: ops.flash_attention(qm, km, vm, qpos, kpos))]
        t_kernel = [time_ms(lambda: ops.flash_attention(q, k, v, qpos, kpos)) for _ in range(2)]
        t_scalar.append(time_ms(lambda: ops.flash_attention(qm, km, vm, qpos, kpos)))
        t_plain.append(time_ms(lambda: fa.flash_attention_plain(q, k, v, qpos, kpos), 1, 5))
        t_lib = time_ms(lambda: sdpa(qt, kt, vt, attn_mask=mask))
        rows[name] = {"shape": dict(zip(("B", "Sq", "Skv", "Hq", "Hkv", "Dh"), shape)),
                      "dtype": "bfloat16", "tile": fa.choose_tile(shape[1], shape[2], shape[5])[:2],
                      "max_abs_err": err, "err_vs_library": err_lib,
                      "kernel_ms": min(t_kernel), "kernel_ms_runs": t_kernel,
                      "kernel_ms_scalar_loads": min(t_scalar),
                      "plain_ms": min(t_plain), "library_ms": t_lib, **bound(q, k, v, qpos, kpos)}
        rows[name]["roofline_share"] = rows[name]["bound_ms"] / rows[name]["kernel_ms"]
    dec = rows["decode"]   # 31 of 32 forward passes of a request are decode steps
    entry = {"name": "flash_attention", "route": "cuda", "source": KERNEL_SOURCE,
             "replaces": KERNEL_REPLACES, "launches": ctx.get("launches", 0),
             "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
             "ms": dec["kernel_ms"], "plain_ms": dec["plain_ms"], "bound_ms": dec["bound_ms"],
             "bound_by": dec["bound_by"], "library_ms": dec["library_ms"],
             "top_level_shape": "decode", "card": ctx.get("card"), "shapes": rows}
    ctx["kernels_line"] = {"kernels": [entry]}
    if "launches" in ctx:
        require(entry["launches"] > 0, "the main path never launched the kernel")
    print(json.dumps(ctx["kernels_line"]), flush=True)


def phase_serve_throughput(ctx):
    server = ctx.get("server")
    require(server is not None, "serve_throughput needs the serve phase")
    snap = server.metrics_snapshot()
    emit("serve_throughput", card=ctx.get("card"), tokens_per_s=snap["tokens_per_s"],
         completions=snap["completions"], tokens=snap["tokens"],
         latency_ms_p50=snap["latency_ms"]["p50"], latency_ms_p99=snap["latency_ms"]["p99"],
         latency_ms_mean=snap["latency_ms"]["mean"], batch_slots=SERVE["batch_slots"],
         max_len=SERVE["max_len"], max_new_tokens=SERVE["max_new_tokens"])


def phase_profile(ctx):
    """Device time by kernel over a few decode steps of the full-width model at
    8 slots, from ``torch.profiler``; the busy share is device time over wall time."""
    from torch.profiler import ProfilerActivity, profile

    server = ctx.get("server")
    require(server is not None, "profile needs the serve phase")
    model, cfg = server.model, server.model.cfg
    rng = np.random.default_rng(2)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, size=(8, 256))).to(model.device)
    _, state = model.prefill({"tokens": tokens}, SERVE["max_len"])
    step = tokens[:, :1]
    for _ in range(3):
        h, state = model.decode_step(step, state)
        model.logits(h)
    torch.cuda.synchronize()
    n_steps = 5

    def run_steps():
        nonlocal state
        for _ in range(n_steps):
            h, state = model.decode_step(step, state)
            model.logits(h).argmax(-1).cpu()
        torch.cuda.synchronize()

    t0 = time.perf_counter()
    run_steps()                      # wall time without the profiler's overhead
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:   # device side only
        run_steps()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    rows = sorted(((dev_us(e), e.key, e.count) for e in prof.key_averages() if dev_us(e) > 0),
                  reverse=True)
    total_ms = sum(r[0] for r in rows) / 1e3
    require(total_ms > 0, "the profiler saw no device time")
    emit("profile", card=ctx.get("card"), steps=n_steps, batch=8,
         wall_ms_per_step=round(wall_ms / n_steps, 3),
         device_ms_per_step=round(total_ms / n_steps, 3),
         device_busy_share=round(total_ms / wall_ms, 4),
         device_kernels_per_step=sum(r[2] for r in rows) / n_steps,
         top=[{"kernel": k[:80], "ms_per_step": round(us / 1e3 / n_steps, 4),
               "calls_per_step": c / n_steps} for us, k, c in rows[:10]])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of: " + ", ".join(PHASES + EXTRA_PHASES))
    args = ap.parse_args(argv)
    wanted = args.phases.split(",")
    unknown = [p for p in wanted if p not in PHASES + EXTRA_PHASES]
    if unknown:
        ap.error(f"unknown phase(s): {unknown}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures on the GPU and has no "
              "CPU fallback", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 comparisons are in full fp32
    ctx = {}
    for phase in PHASES + EXTRA_PHASES:
        if phase in wanted:
            globals()[f"phase_{phase}"](ctx)
    if "card" in ctx:
        print(ctx["card"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
