#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py                 # every phase; needs one CUDA device
    python3 chip_smoke.py --phases device,build,kernel_vs_plain,ssd_vs_plain

It imports ``repro_torch`` only, builds the CUDA kernels from
``src/repro_torch/kernels/csrc/`` with ``nvcc`` (one process a source, all
started together), and drives the port's ten serving paths and its training
path through the entry points a user calls.  Each phase prints one JSON line:

1. ``device``            card name and power limit (``nvidia-smi``), torch / CUDA / nvcc versions
2. ``build``             build seconds, the ``.so``, per-kernel registers / spills / shared
                         memory from ptxas, instantiations named readably
3. ``tune``              the RegDem translator on the host, before anything is served (as
                         ``examples/torch_serve_batched.py`` runs it): each served model's
                         kernel corpus (``repro_torch.data.corpus``) through
                         ``TranslationService.tune`` over an ``ArtifactStore``, then a warm
                         re-tune (all hits, no pass) and a fresh service on the same store
                         (byte-identical); every corpus kernel's choice on maxwell and volta
                         recomputed by the anchored search and held against
                         ``tests/golden/corpus_choices.json``; each corpus kernel's
                         extracted registers / threads / shared memory beside ptxas's
                         registers, spills and static shared memory, and the plan's dynamic
                         shared memory, for the CUDA instantiation that model's serving
                         phase launches (a reading, no threshold); tune seconds a model and
                         the simulator's native engine build seconds
4. ``kernel_vs_plain``   the attention kernel against its plain PyTorch version and the
                         oracle over shapes, dtypes, masks and ragged lengths, at the
                         heads of every served model, and at the heads a rank of a 2- or
                         4-wide model axis computes where those differ (``local_heads``;
                         whisper's also at its 1,500-frame encoder step; tolerance 2e-5 in
                         fp32, 2e-2 in bf16, absolute + relative)
5. ``ssd_vs_plain``      the SSD kernel against its plain version and the sequential
                         oracle on both paths (fp32: fma, bf16: mma): the reference's shape
                         sweep, ragged lengths, an initial state, strided views, p-splits,
                         both full-width shapes, operands off 16-byte boundaries (bit for
                         bit against 16-byte copies), every plan against the default
                         (1e-5), the SSM heads a rank of a 2- or 4-wide model axis scans
                         (``local_heads``, timed in bf16), and the inputs it must refuse
                         (tolerance 2e-4 in fp32, 5e-2 in bf16)
6. ``serve``             ``Server.serve`` on full-width stablelm_3b (32 layers, bf16, random
                         weights from a seed): 16 requests through 8 slots; every attention
                         call must have gone through the kernel (launch count); logits are
                         re-derived through the chunked PyTorch path and compared
7. ``serve_mamba2``      the same on full-width mamba2_370m (48 mamba layers): every prefill
                         layer through the SSD kernel, decode in plain PyTorch; logits
                         against ``ssd_impl="chunked"``
8. ``serve_zamba2``      the same on full-width zamba2_2_7b (54 mamba layers, a shared
                         attention block applied 9 times): both kernels on one path
9. ``serve_qwen2_moe``   the same on full-width qwen2_moe_a2_7b (24 layers, 60 experts top-4
                         and a gated shared expert; 26.7 GiB): prompts over 256 tokens on the
                         capacity path, the rest and every decode step on the exact one
10. ``serve_qwen2_vl``   the same on full-width qwen2_vl_2b (28 layers, GQA 6, tied head),
                         then a vision-prefix prefill (256 patch embeddings, M-RoPE) through
                         ``Model.prefill`` and 8 decode steps
11. ``serve_llama4``     the same on llama4_scout_17b_a16e at full width and 4 of its 48
                         layers (one global period; 48 are 200.7 GiB), then one 8,448-token
                         prompt across the 8,192-token attention chunk and 4 decode steps
12. ``serve_gemma3``,   ``Server.serve`` on full-width gemma3_1b (26 layers, heads of 256,
    ``serve_qwen2_7b``,  a 512-token window on 5 of 6 layers), qwen2_7b (28 layers, GQA 7)
    ``serve_granite``    and granite_8b (36 layers, GQA 4), as ``serve``, each with the
                         float32 check at full depth
13. ``serve_whisper``    whisper_large_v3 at full width and depth (32 + 32 layers, heads of
                         64): 8 slots of 1,500 seeded frame embeddings through
                         ``Model.prefill`` (the encoder, on the kernel's mma path), then 32
                         greedy ``decode_step``s (self- and cross-attention, both on the
                         split path); launches, logits against ``attn_impl="chunked"``, the
                         float32 check at 2 layers
14. ``train``            ``Trainer`` on the card, no kernel (the kernels are forward only):
                         (a) stablelm_3b at full width and depth, 8 steps at 8 x 512 tokens,
                         the loss must fall; (b) at full width and 2 layers, a run with a
                         failure injected at step 5 restarts from its step-4 checkpoint and
                         must end bit for bit where an uninterrupted run ends, and the same
                         for qwen2_moe_a2_7b at 2 layers (4,096 tokens a batch: the MoE
                         capacity path); (c) float32 gradients through ``"chunked"``
                         against ``"xla"`` within 1e-4
15. ``train_mesh``       the meshed trainer on the card's one-rank NCCL mesh (data=1, model=1):
                         ``python -m repro_torch.launch.train ... --fsdp`` as a subprocess at
                         full width and depth beside the train phase's un-meshed run; float32
                         at 2 layers (stablelm_3b and mamba2_370m), meshed against
                         un-meshed within 1e-6 (bit for bit expected, else the first op
                         that differs is named); a checkpoint
                         saved under fsdp restored after ``remesh`` bit for bit; no kernel
16. ``dryrun``           ``python -m repro_torch.launch.dryrun`` on meta tensors (processes of
                         its own, started at train_mesh): every stablelm_3b cell on the
                         one-rank mesh, qwen2_7b, llama4, mamba2_370m, zamba2_2_7b and
                         whisper_large_v3 train_4k / decode_32k and stablelm_3b train_4k
                         on 16 x 16 (11 cells); each record's status, flops,
                         bytes, memory, collectives, errors; each 16 x 16 cell's per-device
                         flops within 1 % of the count from its shapes (a rank's share of
                         the products the model axis splits), printed with its wire and
                         temporary GiB beside the gathered layout's (``split_16x16``)
17. ``select``           the variant selector on the card (the paper's Fig. 9 contract):
                         stablelm_3b at 8 x 512, remat {none, dots, full} x microbatches
                         {1, 4}, each dry-run and costed against the card's memory; only the
                         variants predicted to fit run (1 + 3 steps, measured peak memory);
                         fails if one of them runs out of memory or the chosen one does not run
18. ``kernels``          one line ``{"kernels": [...]}``: for each kernel its launches on
                         the serving paths, error against the plain version, time (``ms``:
                         eager calls between CUDA events, the host's issue time included),
                         device time (``device_ms``: CUDA graphs), plain time, library time
                         (``scaled_dot_product_attention`` under each backend that takes
                         the mask, the fastest kept; a yardstick the port never calls; none
                         exists for the SSD scan) and the card's bound (attention: also
                         ``bound_visible_ms``, the work the positions leave visible), at
                         the shapes the main paths use
19. ``serve_throughput`` per served model: tokens/s and completion latencies, with the card

Each serving path runs with every launch count set to 0 just before it and
read just after, prints its initialisation and serving peaks of device memory
(``init_peak_gb``, ``peak_memory_gb``), and drops its model before the next
one is made: one full-width model on the card at a time.  The MoE and VLM
paths hold the kernel path's logits against ``attn_impl="chunked"`` within
the larger of 1e-1 and twice the spread of ``"xla"`` against ``"chunked"``,
report the share of tokens routed to other experts, and hold the same weights
in float32 within 1e-3 (qwen2_moe at 2 of its layers, whisper at 2).
``--phases serve,...,serve_whisper,profile`` adds a ``torch.profiler`` pass over
a few decode steps and a 512-token prefill of each served model (whisper: the
prefill of its 8 x 1,500 frames), taken while it is on the card (device time
by kernel, device busy share); it is not part of the default run, nor is
``--phases device,dryrun_all``, the dry-run's whole ``--all --mesh both`` sweep
(one process an architecture; its wall time and its ``error`` cells).  The
``run`` line gives the wall time of the whole run and of each phase.

Any failed phase ends the run with a non-zero exit code; there is no CPU
fallback.  The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import gc
import json
import os
import re
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import mamba2_ssd as ssd  # noqa: E402
from repro_torch.models import Model, transformer  # noqa: E402
from repro_torch.runtime import Request, ServeConfig, Server  # noqa: E402

SERVING = ["serve", "serve_mamba2", "serve_zamba2", "serve_qwen2_moe", "serve_qwen2_vl",
           "serve_llama4", "serve_gemma3", "serve_qwen2_7b", "serve_granite", "serve_whisper"]
PHASES = ["device", "build", "tune", "kernel_vs_plain", "ssd_vs_plain", *SERVING, "train",
          "train_mesh", "dryrun", "select", "kernels", "serve_throughput"]
# not run by default: --phases serve,...,serve_whisper,profile; --phases device,dryrun_all
EXTRA_PHASES = ["profile", "dryrun_all"]
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
SSD_TOL = {torch.float32: 2e-4, torch.bfloat16: 5e-2}
# published peaks of one H100 SXM (NVIDIA data sheet): device memory rate and
# dense bf16 tensor-core rate; the bound is stated against these
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
KERNEL_REPLACES = "src/repro/kernels/flash_attention.py:86"
SSD_SOURCE = "src/repro_torch/kernels/csrc/mamba2_ssd.cu"
SSD_REPLACES = "src/repro/kernels/mamba2_ssd.py:37"
#: where every phase puts its tensors (a rehearsal on the CPU may point it there)
DEVICE = torch.device("cuda")
#: each kernel's wrapper, which carries its launch count
WRAPPERS = {"flash_attention": fa.flash_attention, "mamba2_ssd": ssd.mamba2_ssd}


class SmokeFailure(RuntimeError):
    """A phase found something wrong; the run ends with a non-zero exit code."""


def require(cond, message: str) -> None:
    # not `assert`: the checks must hold under `python -O` too
    if not cond:
        raise SmokeFailure(message)


def reset_counts() -> None:
    """Every kernel's launch count to 0: a serving path starts here."""
    for wrapper in WRAPPERS.values():
        wrapper.launches = 0
    fa.flash_attention.launches_by_path = {p: 0 for p in fa.PATHS}
    ssd.mamba2_ssd.launches_by_path = {p: 0 for p in ssd.PATHS}


def read_counts() -> dict:
    return {name: wrapper.launches for name, wrapper in WRAPPERS.items()}


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
    dev = DEVICE

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


def launched_path(before):
    """The one path whose count rose since ``before`` (a copy of ``launches_by_path``)."""
    grew = [p for p, n in fa.flash_attention.launches_by_path.items() if n != before[p]]
    require(len(grew) == 1, f"expected one path to launch, got {grew}")
    return grew[0]


def check_case(name, args, dtype, failures, results, want_path=None, splits=None,
               oracle_kv_heads=None, **kw):
    """One launch against the plain version of the same path and the oracle;
    returns the kernel's output.  ``splits`` goes to the wrapper, which alone
    takes the split path's count.  ``oracle_kv_heads`` holds only the first
    kv heads (and their query heads) against the oracle, whose score matrix
    of a long prompt would not fit for all of them; the plain version sees
    every head."""
    q, k, v, qpos, kpos = args
    before, by_path = fa.flash_attention.launches, dict(fa.flash_attention.launches_by_path)
    if splits is None:
        got = ops.flash_attention(q, k, v, qpos, kpos, **kw)
    else:
        got = fa.flash_attention(q, k, v, qpos, kpos, window=kw.get("window"),
                                 chunk=kw.get("chunk_attn"), splits=splits)
    torch.cuda.synchronize()
    require(fa.flash_attention.launches == before + 1, "the wrapper did not launch the kernel")
    path = launched_path(by_path)
    plain_kw = dict(window=kw.get("window"), chunk=kw.get("chunk_attn"),
                    block_q=kw.get("block_q"), block_kv=kw.get("block_kv"), splits=splits)
    plain = fa.flash_attention_plain(q, k, v, qpos, kpos, **plain_kw)
    n = oracle_kv_heads or k.shape[2]
    rows = n * (q.shape[2] // k.shape[2])
    want = oracle(q[:, :, :rows], k[:, :, :n], v[:, :, :n], qpos, kpos, kw.get("window"),
                  kw.get("chunk_attn"))
    torch.cuda.synchronize()
    err_plain, ok_plain = compare(got, plain, TOL[dtype])
    err_oracle, ok_oracle = compare(got[:, :, :rows], want, TOL[dtype])
    del plain, want
    ok = ok_plain and ok_oracle and (want_path is None or path == want_path)
    results.append({"case": name, "dtype": str(dtype).replace("torch.", ""), "path": path,
                    "err_vs_plain": err_plain, "err_vs_oracle": err_oracle, "ok": ok})
    if not ok:
        failures.append(f"{name} ({results[-1]['dtype']}, {path})")
    return got


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
_MANGLED_MMA = re.compile(r"flash_attention_mma_kernelILi(\d+)ELi(\d+)ELb([01])E")
_MANGLED_SPLIT = re.compile(r"flash_attention_split_kernelILi(\d+)ELi(\d+)E")
_MANGLED_SSD = re.compile(r"mamba2_ssd_kernelI(f|13__nv_bfloat16)Li(\d+)ELi(\d+)E")
_MANGLED_SSD_MMA = re.compile(r"mamba2_ssd_mma_kernelILi(\d+)ELi(\d+)E")


def readable(mangled: str) -> str:
    """The attention kernel's three paths as path, dtype, head-width class and
    tile; the SSD kernel's two paths as path, dtype, state width and p_block."""
    m = _MANGLED.search(mangled)
    if m:
        t, nj, rm, nkj = m.group(1), int(m.group(2)), int(m.group(3)), int(m.group(4))
        return (f"flash_attention<fma, {'float' if t == 'f' else 'bf16'}, Dh<={16 * nj}, "
                f"BQ={16 * rm}, BKV={16 * nkj}>")
    m = _MANGLED_MMA.search(mangled)
    if m:
        dhc, bkv, qreg = int(m.group(1)), int(m.group(2)), m.group(3) == "1"
        return (f"flash_attention<mma, bf16, Dh<={dhc}, BQ=64, BKV={bkv}, "
                f"Q in {'registers' if qreg else 'shared memory'}>")
    m = _MANGLED_SPLIT.search(mangled)
    if m:
        return f"flash_attention<split, bf16, Dh<={m.group(1)}, rows<={m.group(2)}>"
    m = _MANGLED_SSD.search(mangled)
    if m:
        t, n, ps = m.group(1), int(m.group(2)), int(m.group(3))
        return f"mamba2_ssd<fma, {'float' if t == 'f' else 'bf16'}, N={n}, p_block={ps}>"
    m = _MANGLED_SSD_MMA.search(mangled)
    if m:
        return f"mamba2_ssd<mma, bf16, N={m.group(1)}, p_block={m.group(2)}>"
    return mangled


def phase_build(ctx):
    t0 = time.perf_counter()
    info = _build.info()
    res = []
    for r in info.resources():
        entry = {**r, "kernel": readable(r["kernel"])}
        # dynamic shared memory, by the formulas checked below (attention: at
        # Dh = the class, Skv = 1024, the chooser's stages)
        ssd_fma, ssd_mma = _MANGLED_SSD.search(r["kernel"]), _MANGLED_SSD_MMA.search(r["kernel"])
        if ssd_fma:
            entry["ssd_path"], entry["state"] = "fma", int(ssd_fma.group(2))
            entry["p_block"] = int(ssd_fma.group(3))
            entry["dynamic_smem_bytes"] = ssd.smem_bytes(int(ssd_fma.group(2)),
                                                         int(ssd_fma.group(3)), "fma")
        if ssd_mma:
            entry["ssd_path"], entry["state"] = "mma", int(ssd_mma.group(1))
            entry["p_block"] = int(ssd_mma.group(2))
            entry["dynamic_smem_bytes"] = ssd.smem_bytes(int(ssd_mma.group(1)),
                                                         int(ssd_mma.group(2)), "mma")
        fma_k, mma_k = _MANGLED.search(r["kernel"]), _MANGLED_MMA.search(r["kernel"])
        split_k = _MANGLED_SPLIT.search(r["kernel"])
        if fma_k:
            entry["path"] = "fma"
            entry["dynamic_smem_bytes"] = fa.smem_bytes(
                16 * int(fma_k.group(2)), 16 * int(fma_k.group(3)), 16 * int(fma_k.group(4)))
        if mma_k:
            entry["path"], entry["dh_class"] = "mma", int(mma_k.group(1))
            entry["stages"] = fa.MMA_STAGES
            entry["dynamic_smem_bytes"] = fa.mma_smem_bytes(
                int(mma_k.group(1)), int(mma_k.group(2)), 1024)
        if split_k:
            dhc, rc = int(split_k.group(1)), int(split_k.group(2))
            entry["path"], entry["dh_class"] = "split", dhc
            entry["stages"] = fa.split_stages(dhc)
            entry["dynamic_smem_bytes"] = fa.split_smem_bytes(dhc, rc, 1024)
        res.append(entry)
    require(res, "ptxas reported no kernel")
    ctx["resources"] = {r["kernel"]: r for r in res}
    by_kernel = {}
    for name in WRAPPERS:
        mine = [r for r in res if r["kernel"].startswith(name + "<")]
        by_kernel[name] = {
            "instantiations": len(mine),
            "max_registers": max((r["registers"] for r in mine), default=None),
            "spill_bytes": sum(r["spill_store_bytes"] + r["spill_load_bytes"] for r in mine),
        }
    by_path = {}
    for path in fa.PATHS:
        mine = [r for r in res if r.get("path") == path]
        by_path[path] = {
            "instantiations": len(mine),
            "registers": {r["kernel"]: r["registers"] for r in mine},
            "spill_bytes": sum(r["spill_store_bytes"] + r["spill_load_bytes"] for r in mine),
        }
    ssd_by_path = {}
    for path in ssd.PATHS:
        mine = [r for r in res if r.get("ssd_path") == path]
        ssd_by_path[path] = {
            "instantiations": len(mine),
            "registers": {r["kernel"]: r["registers"] for r in mine},
            "spill_bytes": sum(r["spill_store_bytes"] + r["spill_load_bytes"] for r in mine),
        }
    emit("build", seconds=round(info.seconds or time.perf_counter() - t0, 3), reused=info.reused,
         so=os.path.relpath(info.path), sources=[p.name for p in _build.sources()],
         kernels=len(res), max_registers=max(r["registers"] for r in res),
         spill_bytes=sum(r["spill_store_bytes"] + r["spill_load_bytes"] for r in res),
         by_kernel=by_kernel, attention_by_path=by_path, ssd_by_path=ssd_by_path, resources=res)
    # the mma and split paths keep their state in registers at every head width
    # class (64: whisper, 80: stablelm / zamba2, 128, 256: gemma3)
    spilled = [r["kernel"] for r in res if r.get("dh_class") in (64, 80, 128, 256)
               and r["spill_store_bytes"] + r["spill_load_bytes"] > 0]
    require(not spilled, f"spills at Dh = 64 / 80 / 128 / 256: {spilled}")
    # the SSD mma path keeps h in registers at the main paths' state widths
    spilled = [r["kernel"] for r in res if r.get("ssd_path") == "mma" and r["state"] in (64, 128)
               and r["spill_store_bytes"] + r["spill_load_bytes"] > 0]
    require(not spilled, f"SSD mma spills at N = 64 / 128: {spilled}")
    # the chooser's occupancy counts registers from its table: never fewer than ptxas's
    over = [r["kernel"] for r in res if r.get("ssd_path")
            and r["registers"] > ssd.REGISTERS[(r["ssd_path"], r["state"], r["p_block"])]]
    require(not over, f"SSD kernels hold more registers than mamba2_ssd.REGISTERS: {over}")
    # fma: fp32 only, 4 head-width classes x 4 tiles; mma: 4 x 2 KV tiles;
    # split: 4 x 4 row classes, less the 16-row class at Dh 256
    require((by_path["fma"]["instantiations"], by_path["mma"]["instantiations"],
             by_path["split"]["instantiations"]) == (16, 8, 15),
            f"the build's instantiations by path: {[len(v['registers']) for v in by_path.values()]}")
    # the chooser's shared-memory formulas are the kernel's own
    lib = _build.load()
    lib.repro_flash_attention_smem_bytes.argtypes = [ctypes.c_int] * 5
    lib.repro_flash_attention_smem_bytes.restype = ctypes.c_longlong
    smem_c = lib.repro_flash_attention_smem_bytes
    for dh in (16, 80, 128, 144, 256):
        for bq in fa.TILE_Q:
            for bkv in fa.TILE_KV:
                require(smem_c(0, dh, bq, bkv, 1024) == fa.smem_bytes(dh, bq, bkv),
                        f"shared-memory formulas differ at Dh={dh}, tile ({bq}, {bkv})")
        for skv in (1, 1000, 4097):
            for bkv in fa.MMA_TILE_KV:
                require(smem_c(1, dh, 64, bkv, skv) == fa.mma_smem_bytes(dh, bkv, skv),
                        f"mma shared-memory formulas differ at Dh={dh}, BKV={bkv}")
            for rc in fa.SPLIT_ROWS:
                require(smem_c(2, dh, rc, 32, skv) == fa.split_smem_bytes(dh, rc, skv),
                        f"split shared-memory formulas differ at Dh={dh}, rows={rc}")
    lib.repro_mamba2_ssd_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.repro_mamba2_ssd_smem_bytes.restype = ctypes.c_longlong
    for code, path in enumerate(ssd.PATHS):
        for n in ssd.STATE_WIDTHS:
            for ps in ssd.P_BLOCKS:
                require(lib.repro_mamba2_ssd_smem_bytes(code, n, ps) == ssd.smem_bytes(n, ps, path),
                        f"SSD {path} shared-memory formulas differ at N={n}, p_block={ps}")
    # fma: fp32 only; each path 4 state widths x 3 p_blocks
    per_path = len(ssd.STATE_WIDTHS) * len(ssd.P_BLOCKS)
    require(all(ssd_by_path[p]["instantiations"] == per_path for p in ssd.PATHS),
            f"the build's SSD instantiations by path: "
            f"{ {p: v['instantiations'] for p, v in ssd_by_path.items()} }")


#: the model each serving phase drives
SERVED = {"serve": "stablelm_3b", "serve_mamba2": "mamba2_370m", "serve_zamba2": "zamba2_2_7b",
          "serve_qwen2_moe": "qwen2_moe_a2_7b", "serve_qwen2_vl": "qwen2_vl_2b",
          "serve_llama4": "llama4_scout_17b_a16e", "serve_gemma3": "gemma3_1b",
          "serve_qwen2_7b": "qwen2_7b", "serve_granite": "granite_8b",
          "serve_whisper": "whisper_large_v3"}
#: the search of ``examples/torch_serve_batched.py``: one cliff target per
#: architecture, the top beam survivors only
TUNE = dict(max_targets=1, beam_width=2, top_k=1)
GOLDEN_CHOICES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "golden",
                              "corpus_choices.json")


def serving_instantiations(cfg):
    """Corpus kernel kind -> the CUDA instantiation the model's serving phase
    launches for it, with its plan's threads and dynamic shared memory: the
    wrappers' own choosers at the phase's bf16 shapes (a prefill of one prompt
    of up to 512 tokens, whisper's 1,500 encoder frames; a decode step of 8
    slots against the 1,024-position cache, whisper's cross-attention over its
    frames).  The SSD scan's decode step runs no kernel."""
    out = {}
    bf16 = torch.bfloat16
    if cfg.family != "ssm":
        dh, groups = cfg.dh, cfg.n_heads // cfg.n_kv_heads
        audio = cfg.family == "audio"
        dhc = 64 if dh <= 64 else 80 if dh == 80 else 128 if dh <= 128 else 256
        skv = WHISPER["frames"] if audio else 512
        plan = fa.choose_tile(skv, skv, dh, dtype=bf16, groups=groups,
                              batch_kv_heads=cfg.n_kv_heads)
        require(plan.path == "mma", f"{cfg.name}: prefill plan {plan}")
        out["prefill.attn"] = (
            f"flash_attention<mma, bf16, Dh<={dhc}, BQ=64, BKV={plan.bkv}, "
            f"Q in {'registers' if dhc <= 128 else 'shared memory'}>",
            plan.threads, fa.plan_smem_bytes(plan, dh, skv))
        skv = WHISPER["frames"] if audio else SERVE["max_len"]
        plan = fa.choose_tile(1, skv, dh, dtype=bf16, groups=groups,
                              batch_kv_heads=SERVE["batch_slots"] * cfg.n_kv_heads)
        require(plan.path == "split", f"{cfg.name}: decode plan {plan}")
        out["decode.attn"] = (f"flash_attention<split, bf16, Dh<={dhc}, rows<={plan.bq}>",
                              plan.threads, fa.plan_smem_bytes(plan, dh, skv))
    if cfg.family in ("ssm", "hybrid"):
        plan = ssd.choose_plan(1, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, bf16)
        out["prefill.ssd"] = (f"mamba2_ssd<{plan.path}, bf16, N={cfg.ssm_state}, "
                              f"p_block={plan.p_block}>", plan.threads, plan.smem_bytes)
        out["decode.ssd"] = None
    return out


def phase_tune(ctx):
    """Tune each served model's kernel corpus on the host, then read the
    extracted register / shared-memory profile beside ptxas's numbers."""
    import hashlib
    import shutil
    import tempfile

    from repro_torch.core import _native
    from repro_torch.core.anchored import tune_profile
    from repro_torch.core.artifacts import ArtifactStore
    from repro_torch.core.passes import PIPELINE_COUNTERS
    from repro_torch.core.search import SearchConfig
    from repro_torch.core.translator import TranslationService
    from repro_torch.data.corpus import CORPUS_BENCHMARKS, corpus_container, model_corpus_names

    # the simulator's issue loop, compiled from the port's own C file
    with open(_native._SOURCE, "rb") as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()[:16]
    so = os.path.join(_native._cache_dir(), f"sim_engine_{digest}.so")
    reused = os.path.exists(so)
    t0 = time.perf_counter()
    engine = _native.engine()
    native_s = time.perf_counter() - t0
    require(engine is not None, "the simulator's native engine did not build (no C compiler?)")

    with open(GOLDEN_CHOICES) as fh:
        golden = json.load(fh)
    served = [p for p in SERVING if p in ctx["wanted"]] or SERVING
    models = [SERVED[p] for p in served]
    resources = ctx.get("resources")
    config = SearchConfig(**TUNE)
    per_model, mismatches = {}, []
    for model in models:
        names = model_corpus_names(model)
        data = corpus_container(model)
        store = tempfile.mkdtemp(prefix="chip_smoke_store_")
        ctx.setdefault("tmp_dirs", []).append(store)
        svc = TranslationService(store=ArtifactStore(store))
        t0 = time.perf_counter()
        tuned, rep = svc.tune(data, config)
        tune_s = time.perf_counter() - t0
        require(rep.cache_misses == len(names) and rep.cache_hits == 0,
                f"{model}: a cold tune searched {rep.cache_misses} of {len(names)} kernels")
        passes = dict(PIPELINE_COUNTERS)
        t0 = time.perf_counter()
        again, rep2 = svc.tune(data, config)
        warm_s = time.perf_counter() - t0
        require(rep2.cache_hits == len(names) and rep2.cache_misses == 0,
                f"{model}: a warm re-tune had {rep2.cache_misses} misses")
        require(dict(PIPELINE_COUNTERS) == passes, f"{model}: a warm re-tune ran passes")
        restart, rep3 = TranslationService(store=ArtifactStore(store)).tune(data, config)
        require(restart == again == tuned, f"{model}: tuned bytes differ after a restart")
        require(rep3.cache_hits == len(names), f"{model}: a restart missed the store")
        shutil.rmtree(store, ignore_errors=True)

        # the golden choices: each kernel, each architecture, by the anchored search
        t0 = time.perf_counter()
        choices = {}
        for name in names:
            for arch in ("maxwell", "volta"):
                row = tune_profile(CORPUS_BENCHMARKS[name], arch)
                choices[f"{name}/{arch}"] = row["chosen"]
                if (row["chosen"] != golden[name][arch]
                        or row["cycles_chosen"] > row["cycles_fixed"]):
                    mismatches.append({"kernel": name, "arch": arch, "chosen": row["chosen"],
                                       "golden": golden[name][arch],
                                       "cycles_chosen": row["cycles_chosen"],
                                       "cycles_fixed": row["cycles_fixed"]})
        golden_s = time.perf_counter() - t0

        cuda = serving_instantiations(get_config(model))
        kernels = []
        for r in rep.reports:
            prof = CORPUS_BENCHMARKS[r.kernel_name]
            entry = {"kernel": r.kernel_name, "chosen": r.chosen,
                     "speedup_vs_nvcc": round(r.search.speedup, 4),
                     "extracted": {"registers": prof.target_regs,
                                   "threads_per_block": prof.threads_per_block,
                                   "shared_bytes": prof.shared_size,
                                   "regdem_target": prof.regdem_target}}
            inst = cuda[r.kernel_name.split(".", 1)[1]]
            if inst is None:
                entry["measured"] = None
                entry["note"] = "the port's decode step runs no SSD kernel"
            else:
                label, threads, dyn = inst
                entry["measured"] = {"instantiation": label, "threads_per_block": threads,
                                     "dynamic_smem_bytes": dyn}
                if resources is not None:
                    require(label in resources, f"{model}: {label} is not in the build")
                    rec = resources[label]
                    entry["measured"].update(
                        registers=rec["registers"],
                        spill_bytes=rec["spill_store_bytes"] + rec["spill_load_bytes"],
                        static_smem_bytes=rec["static_smem_bytes"])
            kernels.append(entry)
        per_model[model] = {"kernels": len(names), "tune_s": round(tune_s, 4),
                            "warm_retune_s": round(warm_s, 4), "warm_hits": rep2.cache_hits,
                            "golden_recompute_s": round(golden_s, 4), "choices": choices,
                            "corpus": kernels}
    emit("tune", native_engine={"seconds": round(native_s, 4), "reused": reused,
                                "so": os.path.relpath(so)},
         search=TUNE, models=per_model,
         golden_cells=sum(len(m["choices"]) for m in per_model.values()),
         golden_mismatches=mismatches,
         measured_from="ptxas records of the build phase" if resources is not None
         else "not measured: the build phase did not run")
    require(not mismatches, f"corpus choices differ from {os.path.relpath(GOLDEN_CHOICES)}: "
            f"{mismatches}")


ATTN_SHAPES = [
    # (B, Sq, Skv, Hq, Hkv, Dh): the shape sweep of the reference's kernel tests
    (1, 128, 128, 2, 2, 64),
    (2, 128, 128, 4, 1, 64),
    (2, 64, 256, 4, 2, 128),
    (1, 256, 256, 8, 4, 128),
    (2, 128, 128, 4, 4, 256),
]


#: the transformer models whose attention a model axis may split by heads
SPLIT_MODELS = ("stablelm_3b", "gemma3_1b", "qwen2_7b", "granite_8b", "qwen2_moe_a2_7b",
                "qwen2_vl_2b", "llama4_scout_17b_a16e", "zamba2_2_7b", "whisper_large_v3")
#: whisper's encoder: its frames, every key visible to every query
ENCODER_FRAMES = 1500


def local_head_shapes():
    """``(query heads, K / V heads, head width) -> ["arch/width", ...]``: the
    heads a rank of a 2- or 4-wide model axis computes where the split is by
    whole heads (``n_heads`` divides the axis, and the K / V heads they read
    are ``repro_torch.sharding.read_range``'s), but for the full models' own
    shapes."""
    from repro_torch.sharding import read_range

    configs = [get_config(arch) for arch in SPLIT_MODELS]
    full = {(c.n_heads, c.n_kv_heads, c.dh) for c in configs}
    out = {}
    for arch, cfg in zip(SPLIT_MODELS, configs):
        for width in (2, 4):
            heads = cfg.n_heads // width
            kv = read_range((0, heads), cfg.n_heads // cfg.n_kv_heads)
            if cfg.n_heads % width == 0 and kv is not None:
                shape = (heads, kv[1] - kv[0], cfg.dh)
                if shape not in full:
                    out.setdefault(shape, []).append(f"{arch}/{width}")
    return out


def local_head_times(local):
    """bf16 times of the kernel at each of a rank's head shapes (prefill:
    a 512-token prompt from position 0 in a 1,024-slot cache; decode: 8
    serving slots; for whisper's heads also its encoder step, 1,500 frames
    every query sees): device ms from CUDA graphs, eager ms, the plain
    version's eager ms, and the card's bound."""
    rows = []
    T = ENCODER_FRAMES
    for (hq, hkv, dh), where in local.items():
        steps = [("prefill", (1, 512, 1024, np.arange(512)[None])),
                 ("decode", (8, 1, 1024, serve_lengths()[:, None] - 1))]
        if any(w.startswith("whisper") for w in where):
            steps.append(("encoder", (1, T, T, np.full((1, T), T))))
        for step, (B, Sq, Skv, qpos) in steps:
            q, k, v, qp, kp = make_case(B, Sq, Skv, hq, hkv, dh, torch.bfloat16,
                                        q_positions=qpos)

            def run_kernel():
                return ops.flash_attention(q, k, v, qp, kp)

            def run_plain():
                return fa.flash_attention_plain(q, k, v, qp, kp)

            b = bound(q, k, v, qp, kp)
            rows.append({"heads": f"{hq}/{hkv}", "Dh": dh, "step": step, "models": where,
                         "device_ms": min(graph_ms(run_kernel) for _ in range(2)),
                         "ms": time_ms(run_kernel), "plain_ms": time_ms(run_plain, 1, 5),
                         "bound_ms": b["bound_ms"], "bound_by": b["bound_by"]})
    return rows


def serve_lengths(batch=8):
    """Decode slot lengths of the serving phases: the smoke prompts (64-512
    tokens) plus up to 32 new tokens, drawn from seed 1."""
    return np.random.default_rng(1).integers(64, 545, size=batch)


def phase_kernel_vs_plain(ctx):
    failures, results = [], []
    f32, bf16 = torch.float32, torch.bfloat16
    both = (f32, bf16)
    for shape in ATTN_SHAPES:
        for dtype in both:
            check_case(f"shape{shape}", make_case(*shape, dtype), dtype, failures, results,
                       block_q=64, block_kv=64)
    for window in (16, 64):
        for dtype in both:
            check_case(f"window{window}", make_case(2, 128, 128, 4, 2, 64, dtype), dtype,
                       failures, results, window=window, block_q=64, block_kv=64)
    for chunk in (32, 64):
        for dtype in both:
            check_case(f"chunk{chunk}", make_case(2, 128, 128, 4, 2, 64, dtype), dtype,
                       failures, results, chunk_attn=chunk, block_q=64, block_kv=64)
    for bq, bkv in ((16, 32), (16, 64), (64, 32), (64, 64)):
        for dtype in both:
            check_case(f"tile({bq},{bkv})", make_case(1, 128, 128, 2, 2, 64, dtype), dtype,
                       failures, results, block_q=bq, block_kv=bkv)
    for sq, skv in ((1, 512), (7, 19), (100, 300), (37, 1024)):
        for dtype in both:
            check_case(f"ragged({sq},{skv})", make_case(2, sq, skv, 4, 2, 64, dtype), dtype,
                       failures, results)
    for dtype in both:
        check_case("ragged+window32", make_case(2, 100, 100, 4, 2, 64, dtype), dtype, failures,
                   results, window=32)
        check_case("ragged+chunk64", make_case(1, 200, 200, 2, 2, 64, dtype), dtype, failures,
                   results, chunk_attn=64)
        check_case("unrestricted=BIG", make_case(1, 129, 257, 2, 1, 128, dtype), dtype, failures,
                   results, window=fa.BIG, chunk_attn=fa.BIG)
        for dh in (16, 48, 96, 112, 160, 256):
            check_case(f"dh{dh}", make_case(1, 70, 150, 4, 2, dh, dtype), dtype, failures, results)
            check_case(f"dh{dh} decode", make_case(2, 1, 150, 4, 2, dh, dtype), dtype, failures,
                       results)
    # stablelm_3b's heads at the two shapes of the main path
    for dtype in both:
        check_case("dh80 prefill", make_case(1, 512, 1024, 32, 32, 80, dtype), dtype, failures,
                   results, want_path="fma" if dtype == f32 else "mma")
        check_case("dh80 decode", make_case(8, 1, 1024, 32, 32, 80, dtype), dtype, failures,
                   results, want_path="fma" if dtype == f32 else "split")
    # decode with unequal slot lengths: one query row a slot, each at its own position
    lengths = np.random.default_rng(1).integers(1, 1024, size=(8, 1))
    for dtype in both:
        check_case("decode unequal positions",
                   make_case(8, 1, 1024, 32, 32, 80, dtype, q_positions=lengths), dtype,
                   failures, results)
    # grouped-query decode by rows: qwen2_7b (28/4) and granite_8b (32/8) heads
    for hq, hkv in ((28, 4), (32, 8)):
        check_case(f"GQA {hq}/{hkv} decode unequal",
                   make_case(8, 1, 1024, hq, hkv, 128, bf16,
                             q_positions=serve_lengths()[:, None] - 1),
                   bf16, failures, results, want_path="split")
    # the heads of the MoE and VLM models, all 128 wide: decode of qwen2_vl_2b
    # (12/2, GQA 6) and llama4_scout (40/8, GQA 5) in the split path's 8-row
    # class; prefill of qwen2_moe (16/16) and qwen2_vl on mma; llama4's chunked
    # layers on one prompt of 8,448 tokens, across the 8,192-token chunk boundary
    for hq, hkv in ((12, 2), (40, 8)):
        plan = fa.choose_tile(1, 1024, 128, dtype=bf16, groups=hq // hkv, batch_kv_heads=8 * hkv)
        require((plan.path, plan.bq) == ("split", 8), f"GQA {hq}/{hkv} decode: plan {plan}")
        for dtype in both:
            check_case(f"GQA {hq}/{hkv} decode unequal",
                       make_case(8, 1, 1024, hq, hkv, 128, dtype,
                                 q_positions=serve_lengths()[:, None] - 1),
                       dtype, failures, results, want_path="split" if dtype == bf16 else "fma")
    for hq, hkv in ((16, 16), (12, 2)):
        for dtype in both:
            check_case(f"prefill {hq}/{hkv}, Dh 128",
                       make_case(1, 512, 1024, hq, hkv, 128, dtype,
                                 q_positions=np.arange(512)[None]),
                       dtype, failures, results, want_path="mma" if dtype == bf16 else "fma")
    # a rank's heads on a 2- or 4-wide model axis: a 512-token prefill on mma
    # and a decode step of 8 slots on split (fma in fp32)
    local = local_head_shapes()
    for (hq, hkv, dh), where in local.items():
        for dtype in both:
            bf = dtype == bf16
            check_case(f"local heads {hq}/{hkv}, Dh {dh}, prefill ({', '.join(where)})",
                       make_case(1, 512, 1024, hq, hkv, dh, dtype,
                                 q_positions=np.arange(512)[None]),
                       dtype, failures, results, want_path="mma" if bf else "fma")
            check_case(f"local heads {hq}/{hkv}, Dh {dh}, decode ({', '.join(where)})",
                       make_case(8, 1, 1024, hq, hkv, dh, dtype,
                                 q_positions=serve_lengths()[:, None] - 1),
                       dtype, failures, results, want_path="split" if bf else "fma")
            if any(w.startswith("whisper") for w in where):
                T = ENCODER_FRAMES
                check_case(f"local heads {hq}/{hkv}, Dh {dh}, encoder ({', '.join(where)})",
                           make_case(1, T, T, hq, hkv, dh, dtype, q_positions=np.full((1, T), T)),
                           dtype, failures, results, want_path="mma" if bf else "fma",
                           oracle_kv_heads=2)
    check_case("chunk 8192, an 8,448-token prompt, 40/8",
               make_case(1, 8448, 8448, 40, 8, 128, bf16, q_positions=np.arange(8448)[None]),
               bf16, failures, results, want_path="mma", chunk_attn=8192, oracle_kv_heads=1)
    # whisper's heads (20 of 64): the encoder's self-attention over 1,500 frames,
    # every query seeing every frame (position T), on mma; a decode step's
    # self-attention in a 448-slot cache and its cross-attention over the
    # frames, on split.  gemma3's heads (4 / 1 of 256) with its 512-token
    # window: a prefill on mma, a decode step (4 rows) on split
    T = 1500
    for dtype in both:
        bf = dtype == bf16
        check_case("whisper encoder, all frames", make_case(2, T, T, 20, 20, 64, dtype,
                                                            q_positions=np.full((2, T), T)),
                   dtype, failures, results, want_path="mma" if bf else "fma", oracle_kv_heads=2)
        check_case("whisper decode self", make_case(8, 1, 448, 20, 20, 64, dtype,
                                                    q_positions=np.arange(8)[:, None] * 7),
                   dtype, failures, results, want_path="split" if bf else "fma")
        check_case("whisper decode cross", make_case(8, 1, T, 20, 20, 64, dtype,
                                                     q_positions=np.full((8, 1), T)),
                   dtype, failures, results, want_path="split" if bf else "fma")
        check_case("gemma3 prefill, window 512", make_case(1, 544, 1024, 4, 1, 256, dtype,
                                                           q_positions=np.arange(544)[None]),
                   dtype, failures, results, want_path="mma" if bf else "fma", window=512)
        check_case("gemma3 decode, window 512",
                   make_case(8, 1, 1024, 4, 1, 256, dtype,
                             q_positions=serve_lengths()[:, None] - 1),
                   dtype, failures, results, want_path="split" if bf else "fma", window=512)
    # at Dh 256 the split path's widest class is 8 rows; 9-16 rows go to mma
    check_case("Dh 256, 8 rows", make_case(2, 2, 700, 16, 4, 256, bf16,
                                           q_positions=[[300, 690], [5, 6]]),
               bf16, failures, results, want_path="split", window=333)
    check_case("Dh 256, 16 rows", make_case(2, 4, 700, 16, 4, 256, bf16,
                                            q_positions=[[100, 300, 500, 690], [5, 6, 7, 8]]),
               bf16, failures, results, want_path="mma", window=333)
    # every key masked (query positions before the first key): the mean of the v rows
    for dtype in both:
        check_case("all keys masked", make_case(1, 5, 70, 2, 2, 64, dtype,
                                                q_positions=np.full((1, 5), -3)), dtype,
                   failures, results)
        check_case("all keys masked, 70 rows", make_case(1, 70, 200, 2, 2, 64, dtype,
                                                         q_positions=np.full((1, 70), -3)),
                   dtype, failures, results)
    # tile skipping: serve-like positions, a window that starts mid-tile, and a
    # fully masked row in a block next to tiles the other blocks skip
    check_case("skip: serve prefill", make_case(1, 512, 1024, 32, 32, 80, bf16,
                                                q_positions=np.arange(512)[None]),
               bf16, failures, results, want_path="mma")
    check_case("skip: serve decode", make_case(8, 1, 1024, 32, 32, 80, bf16,
                                               q_positions=serve_lengths()[:, None] - 1),
               bf16, failures, results, want_path="split")
    for dtype in both:
        qp = np.arange(300, 400)[None].repeat(2, 0)
        check_case("skip: window 77 mid-tile", make_case(2, 100, 1024, 4, 2, 64, dtype,
                                                         q_positions=qp),
                   dtype, failures, results, window=77)
        check_case("skip: window 77 decode", make_case(2, 1, 1024, 4, 2, 64, dtype,
                                                       q_positions=[[333], [700]]),
                   dtype, failures, results, window=77)
    qp = np.arange(0, 200)[None].copy()
    qp[0, 70] = -3                          # row 70 (second block) sees nothing
    check_case("skip: masked row beside skipped tiles", make_case(1, 200, 1024, 2, 2, 64, bf16,
                                                                  q_positions=qp),
               bf16, failures, results, want_path="mma")
    check_case("skip: masked slot beside skipped tiles",
               make_case(3, 1, 1024, 4, 2, 64, bf16, q_positions=[[40], [-3], [500]]),
               bf16, failures, results, want_path="split")
    # split-count overrides agree with one split (and each with its plain version)
    for hq, hkv, dh in ((32, 32, 80), (28, 4, 128)):
        args = make_case(8, 1, 1024, hq, hkv, dh, bf16, q_positions=serve_lengths()[:, None] - 1)
        one = check_case(f"splits=1 {hq}/{hkv}", args, bf16, failures, results, splits=1,
                         want_path="split")
        for n in (2, 5, 13, 64):
            got = check_case(f"splits={n} {hq}/{hkv}", args, bf16, failures, results, splits=n,
                             want_path="split")
            err, ok = compare(got, one, TOL[bf16])
            results.append({"case": f"splits={n} vs 1 {hq}/{hkv}", "dtype": "bfloat16",
                            "path": "split", "err_vs_plain": err, "ok": ok})
            if not ok:
                failures.append(f"splits={n} vs 1 {hq}/{hkv}")
    # the same inputs in both dtypes: fp32 takes fma, bf16 the path its rows give
    for dtype in both:
        bf = dtype == bf16
        check_case("GQA 8/2 decode", make_case(4, 1, 600, 8, 2, 80, dtype), dtype, failures,
                   results, want_path="split" if bf else "fma")
        check_case("GQA 8/2, 3 queries (12 rows)", make_case(2, 3, 333, 8, 2, 128, dtype), dtype,
                   failures, results, want_path="split" if bf else "fma")
        check_case("GQA 8/2, 5 queries (20 rows)", make_case(2, 5, 333, 8, 2, 128, dtype), dtype,
                   failures, results, want_path="mma" if bf else "fma")
        check_case("prefill 100", make_case(1, 100, 300, 4, 4, 80, dtype), dtype, failures,
                   results, want_path="mma" if bf else "fma")
    # strided operands: a window of a longer cache and every other head, no copy
    for sq in (33, 1):
        q, k, v, qpos, kpos = make_case(2, sq, 300, 8, 4, 64, bf16)
        check_case(f"strided views Sq={sq}", (q[:, :, ::2], k[:, 40:240, ::2], v[:, 40:240, ::2],
                                              qpos, kpos[:, 40:240]), bf16, failures, results)
    # operands that do not start on a 16-byte boundary: the element-wise loads
    for dtype in both:
        for sq in (37, 1):
            q, k, v, qpos, kpos = make_case(2, sq, 300, 4, 2, 80, dtype)
            check_case(f"misaligned operands Sq={sq}", (misaligned(q), misaligned(k),
                                                        misaligned(v), qpos, kpos),
                       dtype, failures, results)
    paths = {p: sum(r.get("path") == p for r in results) for p in fa.PATHS}
    require(all(paths.values()), f"a path was never checked: {paths}")
    emit("kernel_vs_plain", cases=len(results), failed=failures, cases_by_path=paths,
         local_heads={f"{hq}/{hkv}, Dh {dh}": where for (hq, hkv, dh), where in local.items()},
         local_heads_timed=local_head_times(local) if not failures else "not measured",
         max_err_fp32=max(r.get("err_vs_oracle", 0) for r in results if r["dtype"] == "float32"),
         max_err_bf16=max(r.get("err_vs_oracle", 0) for r in results if r["dtype"] == "bfloat16"),
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
        (lambda: fa.flash_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(), qpos, kpos,
                                    splits=0), ValueError),
        (lambda: ops.flash_attention(q.requires_grad_(), k, v, qpos, kpos), RuntimeError),
    ):
        before = fa.flash_attention.launches
        try:
            bad()
        except exc:
            require(fa.flash_attention.launches == before, "a refused input counted as a launch")
        else:
            raise SmokeFailure("the wrapper took an input the kernel does not take")


SSD_SHAPES = [
    # (B, S, H, P, N): the shape sweep of the reference's kernel tests
    (1, 64, 2, 16, 16),
    (2, 128, 4, 32, 32),
    (1, 96, 8, 16, 64),
    (2, 64, 4, 64, 16),
]
#: the two models' heads: (H, P, N) of mamba2_370m and zamba2_2_7b
SSD_MODELS = {"mamba2_370m": (32, 64, 128), "zamba2_2_7b": (80, 64, 64)}


def ssd_local_shapes():
    """``(H, P, N) -> "arch/width"``: the SSM heads a rank of a 2- or 4-wide
    model axis scans (``models.mamba2.split_products``): mamba2's 16 and 8,
    zamba2's 40 and 20."""
    return {(H // width, P, N): f"{model}/{width}" for model, (H, P, N) in SSD_MODELS.items()
            for width in (2, 4) if H % width == 0}


def ssd_local_times(local):
    """bf16 times of the kernel at each of a rank's head counts, a 512-token
    prefill in the model's layout (fp32 dt and y): device ms from CUDA
    graphs, eager ms, the plain version's eager ms, the byte bound, and the
    plan's blocks beside the card's SMs (a grid that does not fill them)."""
    rows = []
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for (H, P, N), where in local.items():
        args = make_ssd(1, 512, H, P, N, torch.bfloat16, model_layout=True, decays="model")
        plan = ssd.choose_plan(1, H, P, N, torch.bfloat16)

        def run():
            return ops.mamba2_ssd(*args, out_dtype=torch.float32)

        def plain():
            return ssd.ssd_plain(*args, out_dtype=torch.float32)

        y, h = run()
        b = ssd_bound(*args, y, h)
        rows.append({"heads": H, "P": P, "N": N, "model": where, "S": 512, "path": plan.path,
                     "p_block": plan.p_block, "blocks": plan.blocks, "sms": sms,
                     "device_ms": min(graph_ms(run) for _ in range(2)), "ms": time_ms(run),
                     "plain_ms": time_ms(plain, 1, 5), "bound_ms": b["bound_ms"],
                     "bound_by": b["bound_by"]})
    return rows


def make_ssd(B, S, H, P, N, dtype, seed=0, model_layout=False, decays="reference"):
    """SSD inputs from a seeded numpy generator, on the card.  ``model_layout``
    cuts x, B and C out of one ``(B, S, H*P + 2N)`` tensor as the model does
    (strided views, no copy); ``decays="model"`` takes ``a`` as the model's
    initial ``-linspace(1, 16, H)``, else as the reference's tests draw it."""
    rng = np.random.default_rng(seed)
    dev = DEVICE

    def t(shape, scale):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * scale).to(dev)

    if model_layout:
        xbc = t((B, S, H * P + 2 * N), 0.5).to(dtype)
        x = xbc[..., :H * P].reshape(B, S, H, P)
        bm, cm = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
    else:
        x = t((B, S, H, P), 0.5).to(dtype)
        bm, cm = t((B, S, N), 0.4).to(dtype), t((B, S, N), 0.4).to(dtype)
    dt = torch.nn.functional.softplus(t((B, S, H), 1.0))
    if decays == "model":
        a = -torch.linspace(1.0, 16.0, H, device=dev)
    else:
        a = -torch.exp(t((H,), 0.3))
    return x, dt, a, bm, cm


def ssd_path_launched(before):
    """The one SSD path whose count rose since ``before``."""
    grew = [p for p, n in ssd.mamba2_ssd.launches_by_path.items() if n != before[p]]
    require(len(grew) == 1, f"expected one SSD path to launch, got {grew}")
    return grew[0]


def check_ssd(name, args, failures, results, h0=None, p_block=None, out_dtype=None):
    """One kernel launch against ``ssd_plain`` and the sequential oracle;
    returns the kernel's ``(y, h)``."""
    x = args[0]
    before, by_path = ssd.mamba2_ssd.launches, dict(ssd.mamba2_ssd.launches_by_path)
    y, h = ops.mamba2_ssd(*args, h0=h0, p_block=p_block, out_dtype=out_dtype)
    torch.cuda.synchronize()
    require(ssd.mamba2_ssd.launches == before + 1, "the SSD wrapper did not launch the kernel")
    path = ssd_path_launched(by_path)
    y_plain, h_plain = ssd.ssd_plain(*args, h0=h0, out_dtype=out_dtype)
    y_ref, h_ref = ref.ssd_reference(*args, h0=h0)
    torch.cuda.synchronize()
    tol = SSD_TOL[x.dtype]
    errs = {}
    ok = (y.dtype == (out_dtype or x.dtype) and h.dtype == torch.float32
          and path == ssd.choose_path(x.dtype))
    for key, got, want in (("y_vs_plain", y, y_plain), ("h_vs_plain", h, h_plain),
                           ("y_vs_oracle", y, y_ref), ("h_vs_oracle", h, h_ref)):
        errs[key], good = compare(got, want, tol)
        ok = ok and good
    results.append({"case": name, "dtype": str(x.dtype).replace("torch.", ""), "path": path,
                    "shape": list(x.shape) + [args[3].shape[-1]], "p_block": p_block,
                    **errs, "ok": ok})
    if not ok:
        failures.append(f"{name} ({results[-1]['dtype']}, {path})")
    return y, h


def check_same(name, dtype, path, got, want, tol, failures, results):
    """Two kernel results held against each other (``tol`` 0: bit for bit)."""
    errs, ok = {}, True
    for key, g, w in (("y_vs_plain", got[0], want[0]), ("h_vs_plain", got[1], want[1])):
        errs[key], good = compare(g, w, tol)
        ok = ok and good and (tol > 0 or torch.equal(g, w))
    results.append({"case": name, "dtype": str(dtype).replace("torch.", ""), "path": path,
                    "tolerance": tol, **errs, "ok": ok})
    if not ok:
        failures.append(name)


def phase_ssd_vs_plain(ctx):
    failures, results = [], []
    f32, bf16 = torch.float32, torch.bfloat16
    both = (f32, bf16)
    for shape in SSD_SHAPES:
        for dtype in both:
            check_ssd(f"shape{shape}", make_ssd(*shape, dtype), failures, results)
    # a bf16 dt, as tests/test_kernels.py::test_ssd_kernel_bf16 feeds it
    x, dt, a, bm, cm = make_ssd(1, 64, 4, 16, 32, bf16)
    check_ssd("bf16 dt", (x, dt.bfloat16(), a, bm, cm), failures, results)
    # ragged lengths: not a multiple of the kernel's 64-row chunk
    for S in (1, 3, 63, 65, 100, 200):
        for dtype in both:
            check_ssd(f"ragged S={S}", make_ssd(2, S, 4, 32, 64, dtype, seed=S), failures, results)
    # an initial state, and an initial state with a ragged length
    for S in (64, 77):
        for dtype in both:
            x, dt, a, bm, cm = make_ssd(2, S, 4, 32, 32, dtype, seed=3)
            h0 = torch.from_numpy(np.random.default_rng(4).standard_normal(
                (2, 4, 32, 32), dtype=np.float32) * 0.3).to(DEVICE)
            check_ssd(f"h0, S={S}", (x, dt, a, bm, cm), failures, results, h0=h0)
    # strided views, the model's layout: x, B and C columns of one tensor
    for dtype in both:
        check_ssd("strided views", make_ssd(2, 100, 4, 32, 64, dtype, model_layout=True),
                  failures, results)
    # p-splits: each block owns 16, 32 or 64 rows of a head's state; every plan
    # against the default plan at 1e-5 (the split does not change the result)
    for dtype in both:
        args = make_ssd(1, 130, 4, 64, 64, dtype, model_layout=True)
        path = ssd.choose_path(dtype)
        default = check_ssd("default plan", args, failures, results, out_dtype=f32)
        for ps in ssd.P_BLOCKS:
            got = check_ssd(f"p_block={ps}", args, failures, results, p_block=ps, out_dtype=f32)
            check_same(f"p_block={ps} vs default ({path})", dtype, path, got, default, 1e-5,
                       failures, results)
    # float32 y from bf16 inputs: what the model asks for
    check_ssd("bf16 in, fp32 out", make_ssd(1, 100, 4, 32, 64, bf16, model_layout=True),
              failures, results, out_dtype=f32)
    # operands that do not start on a 16-byte boundary: the mma path's
    # element-wise fill must give what its 16-byte copies give, bit for bit
    for model, (H, P, N) in SSD_MODELS.items():
        x, dt, a, bm, cm = make_ssd(1, 300, H, P, N, bf16, model_layout=True, decays="model")
        got = check_ssd(f"{model} misaligned operands",
                        (misaligned(x), dt, a, misaligned(bm), misaligned(cm)), failures,
                        results, out_dtype=f32)
        want = ops.mamba2_ssd(x, dt, a, bm, cm, out_dtype=f32)
        check_same(f"{model} element-wise vs 16-byte loads", bf16, "mma", got, want, 0.0,
                   failures, results)
    # both models' heads at full width, in the model's layout and with its decays
    for model, (H, P, N) in SSD_MODELS.items():
        for S in (64, 300, 512):
            check_ssd(f"{model} S={S}", make_ssd(1, S, H, P, N, bf16, model_layout=True,
                                                 decays="model"),
                      failures, results, out_dtype=f32)
        check_ssd(f"{model} fp32 S=300", make_ssd(1, 300, H, P, N, f32, model_layout=True,
                                                  decays="model"), failures, results)
    # a rank's heads on a 2- or 4-wide model axis, in the model's layout (its
    # heads' x beside B / C), from a zero and from a carried state
    local = ssd_local_shapes()
    for (H, P, N), where in local.items():
        h0 = torch.from_numpy(np.random.default_rng(5).standard_normal(
            (1, H, P, N), dtype=np.float32) * 0.3).to(DEVICE)
        for dtype in both:
            args = make_ssd(1, 300, H, P, N, dtype, model_layout=True, decays="model")
            for start in (None, h0):
                check_ssd(f"local heads {H} ({where}), {'h0' if start is not None else 'zero'}",
                          args, failures, results, h0=start, out_dtype=f32)
    paths = {p: sum(r.get("path") == p for r in results) for p in ssd.PATHS}
    require(all(paths.values()), f"an SSD path was never checked: {paths}")
    emit("ssd_vs_plain", cases=len(results), failed=failures, cases_by_path=paths,
         max_err_fp32=max(max(r.get("y_vs_oracle", 0), r["y_vs_plain"]) for r in results
                          if r["dtype"] == "float32"),
         max_err_bf16=max(max(r.get("y_vs_oracle", 0), r["y_vs_plain"]) for r in results
                          if r["dtype"] == "bfloat16"),
         tolerance={"float32": 2e-4, "bfloat16": 5e-2, "plans": 1e-5, "misaligned": 0.0},
         local_heads={f"{H} heads, P {P}, N {N}": where for (H, P, N), where in local.items()},
         local_heads_timed=ssd_local_times(local) if not failures else "not measured",
         results=results)
    require(not failures, f"SSD kernel disagrees on: {failures}")

    # what the wrapper must refuse rather than hand to the plain version
    x, dt, a, bm, cm = make_ssd(1, 64, 2, 32, 32, f32)
    for bad, exc in (
        (lambda: ops.mamba2_ssd(x.half(), dt, a, bm.half(), cm.half()), TypeError),
        (lambda: ops.mamba2_ssd(x, dt, a, bm.bfloat16(), cm.bfloat16()), TypeError),
        (lambda: ops.mamba2_ssd(x, dt, a, bm, cm, out_dtype=torch.bfloat16), TypeError),
        (lambda: ops.mamba2_ssd(x, dt, a, bm[..., :24], cm[..., :24]), ValueError),
        (lambda: ops.mamba2_ssd(x[..., :24], dt, a, bm, cm), ValueError),
        (lambda: ops.mamba2_ssd(x, dt, a, bm, cm, p_block=128), ValueError),
        (lambda: ops.mamba2_ssd(x.bfloat16(), dt, a, bm.bfloat16(), cm.bfloat16(), p_block=64),
         ValueError),
        (lambda: ops.mamba2_ssd(x.transpose(2, 3).contiguous().transpose(2, 3), dt, a, bm, cm),
         ValueError),
        (lambda: ops.mamba2_ssd(x.requires_grad_(), dt, a, bm, cm), RuntimeError),
    ):
        before = (ssd.mamba2_ssd.launches, dict(ssd.mamba2_ssd.launches_by_path))
        try:
            bad()
        except exc:
            require((ssd.mamba2_ssd.launches, ssd.mamba2_ssd.launches_by_path) == before,
                    "a refused input counted as a launch")
        else:
            raise SmokeFailure("the SSD wrapper took an input the kernel does not take")


SERVE = dict(batch_slots=8, max_len=1024, max_new_tokens=32, n_requests=16, seed=0)


def weights_gb(model) -> float:
    return sum(p.numel() * p.element_size() for p in model.parameters()) / 2**30


def with_routes(fn):
    """``fn()`` with the experts of every router call recorded, each row
    sorted: ``(result, [(T, top_k) tensors])``."""
    seen, route = [], transformer.route

    def recording(x, lp, m):
        gate, expert = route(x, lp, m)
        seen.append(expert.sort(dim=-1).values)
        return gate, expert

    transformer.route = recording
    try:
        return fn(), seen
    finally:
        transformer.route = route


def route_agreement(got, want):
    """The share of (layer, token) rows whose routed expert set differs."""
    rows = sum(g.shape[0] for g in got)
    differ = sum(int((g != w).any(-1).sum()) for g, w in zip(got, want))
    return {"rows": rows, "differing": differ, "share": differ / rows if rows else 0.0}


def logits_of(model, batch, max_len, token=None, **attrs):
    """Logits of the prefill of ``batch`` and of the first decode step after
    it, fed ``token`` (by default the prefill's own greedy choice), with the
    model's attributes set to ``attrs`` for the call (another path:
    ``attn_impl`` / ``ssd_impl``, or another ``cfg``), and the router's
    choices on the way."""
    kept = {k: getattr(model, k) for k in attrs}
    for k, v in attrs.items():
        setattr(model, k, v)

    def run():
        h, state = model.prefill(batch, max_len)
        pre = model.logits(h[:, -1:])[:, 0].float()
        h, state = model.decode_step(pre.argmax(-1, keepdim=True) if token is None else token,
                                     state)
        return pre, model.logits(h[:, -1:])[:, 0].float()

    try:
        return with_routes(run)
    finally:
        for k, v in kept.items():
            setattr(model, k, v)


def agreement(got, want, tol):
    (pre_k, dec_k), routes_k = got
    (pre_c, dec_c), routes_c = want
    err_pre, ok_pre = compare(pre_k, pre_c, tol)
    err_dec, ok_dec = compare(dec_k, dec_c, tol)
    argmax = [bool((pre_k.argmax(-1) == pre_c.argmax(-1)).all()),
              bool((dec_k.argmax(-1) == dec_c.argmax(-1)).all())]
    out = {"prefill_err": err_pre, "decode_err": err_dec, "argmax_agrees": argmax,
           "within": ok_pre and ok_dec}
    if routes_k:
        out["routes"] = route_agreement(routes_k, routes_c)
    return out


def logit_checks(model, batch, max_len, compare_impl, tol, spread, model32):
    """The kernel path's logits against the plain path's (``compare_impl``)
    on one prompt: the prefill, and the first decode step fed the plain
    path's greedy token on both paths (at a near tie the two prefills may
    choose apart, and the step must compare one function on one input).
    With ``spread`` (attributes that leave the function as it is and move
    only roundings of the plain path) the bf16 tolerance is the larger of
    ``tol`` and twice the plain path's spread against itself; with
    ``model32`` the same weights in float32 must agree within 1e-3."""
    plain_path = logits_of(model, batch, max_len, **compare_impl)
    token = plain_path[0][0].argmax(-1, keepdim=True)
    kernel_path = logits_of(model, batch, max_len, token)
    checks = {}
    if spread is not None:
        spread_run = agreement(logits_of(model, batch, max_len, token, **spread), plain_path,
                               0.0)
        tol = max(tol, 2 * max(spread_run["prefill_err"], spread_run["decode_err"]))
        changed = {}
        for k, v in spread.items():
            if k == "cfg":      # the fields of the config that differ
                changed.update({f.name: getattr(v, f.name) for f in dataclasses.fields(v)
                                if getattr(v, f.name) != getattr(model.cfg, f.name)})
            else:
                changed[k] = v
        checks["plain_vs_itself"] = {"changed": changed, **spread_run}
    if model32 is not None:
        plain32 = logits_of(model32, batch, max_len, **compare_impl)
        token32 = plain32[0][0].argmax(-1, keepdim=True)
        checks["float32"] = {"tolerance": 1e-3, "layers": model32.cfg.n_layers,
                             **agreement(logits_of(model32, batch, max_len, token32), plain32,
                                         1e-3)}
    checks["bfloat16"] = {"tolerance": tol, **agreement(kernel_path, plain_path, tol)}
    checks["logits_max_abs"] = float(plain_path[0][0].abs().max())
    return checks


def serve_path(ctx, phase, arch, expected, compare_impl, tol, why, spread=None, cuts=None,
               fp32_layers=None, extra=None):
    """``Server.serve`` on the full-width ``arch`` (bf16, random weights from a
    seed; ``cuts`` changes the config, e.g. its depth, and is stated): 16
    requests with prompts of 64-512 tokens through 8 slots, greedy, after a
    warm-up request.  Every launch count is set to 0 just before the run and
    read just after; ``expected(prefills, forwards)`` gives the count each
    kernel must reach.  ``extra(ctx, server)`` then runs what the phase adds
    (with its own counts) and returns more prompts for the logit checks and
    fields to print.  Then the logits of each check prompt's prefill and
    first decode step through the kernels are held against those through
    ``compare_impl`` (the plain PyTorch paths), by :func:`logit_checks`.

    In bf16 the two paths must agree within ``tol`` (reason: ``why``), or
    within twice the spread that the plain path shows against itself under
    ``spread`` where that is larger; whether they pick the same tokens (and,
    for a mixture of experts, the same experts) is reported.  With ``spread``
    given, the same weights in float32 (the first ``fp32_layers`` layers
    where the model in float32 would not fit beside its bf16 copy) must also
    agree within 1e-3 and pick the same tokens on the first prompt.

    The phase's model is its only one on the card: it is dropped at the end,
    and the throughput line and the profile keep only what they need."""
    cfg = dataclasses.replace(get_config(arch), **(cuts or {}))
    dev = DEVICE
    base_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model(cfg, device=dev).init(seed=SERVE["seed"])
    scfg = ServeConfig(batch_slots=SERVE["batch_slots"], max_len=SERVE["max_len"],
                       max_new_tokens=SERVE["max_new_tokens"], eos=-1)
    server = Server(cfg, scfg, model.state_dict(), device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak_gb = (torch.cuda.max_memory_allocated() - base_bytes) / 2**30
    n_params = sum(p.numel() for p in server.model.parameters())
    w_gb = weights_gb(server.model)
    # the weights are drawn in place, block by block, and adopted: no second copy
    require(init_peak_gb <= w_gb + 4.0, f"{cfg.name}: initialisation peak "
            f"{init_peak_gb:.2f} GiB over {w_gb:.2f} GiB of weights")

    rng = np.random.default_rng(SERVE["seed"])
    lengths = rng.integers(64, 513, size=SERVE["n_requests"])
    requests = [Request(uid=i, prompt=rng.integers(0, cfg.vocab, size=int(n)).astype(np.int32))
                for i, n in enumerate(lengths)]

    # warm-up outside the measured run: one short request through a second
    # server on the same weights (library handles, allocator, first launches)
    warm = Server(cfg, dataclasses.replace(scfg, max_new_tokens=3), model.state_dict(), device=dev)
    warm.serve([Request(uid=-1, prompt=requests[0].prompt[:64])])
    torch.cuda.synchronize()
    del warm, model

    # count and time forward passes by wrapping the two step functions of the
    # server; the synchronise is the one sampling makes anyway right after.
    # A mixture of experts also counts its layers' calls by path and step
    steps = {"prefill": 0, "decode": 0}
    step_ms = {"prefill": [], "decode": []}
    nan_seen = []
    current = {"step": None}
    moe_calls = {k: {"capacity": 0, "exact": 0} for k in steps}
    moe_ffn = transformer.moe_ffn

    def moe_counted(x, *args, **kw):
        path = "capacity" if x.shape[0] > transformer.DENSE_PATH_MAX_TOKENS else "exact"
        moe_calls[current["step"]][path] += 1
        return moe_ffn(x, *args, **kw)

    def counted(fn, key):
        def wrapper(*args):
            steps[key] += 1
            current["step"] = key
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
    transformer.moe_ffn = moe_counted
    try:
        reset_counts()              # the path starts here
        t0 = time.perf_counter()
        done = server.serve(requests)
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        launches = read_counts()    # ... and ends here
    finally:
        transformer.moe_ffn = moe_ffn
    attn_paths = dict(fa.flash_attention.launches_by_path)
    ssd_paths = dict(ssd.mamba2_ssd.launches_by_path)
    # this path's own: the memory held before its model was made is not counted
    peak_gb = (torch.cuda.max_memory_allocated() - base_bytes) / 2**30
    ctx.setdefault("launches", {})[phase] = launches
    ctx.setdefault("attention_paths", {})[phase] = attn_paths
    ctx.setdefault("ssd_paths", {})[phase] = ssd_paths

    require([c.uid for c in done] == list(range(SERVE["n_requests"])), "completions out of order")
    require(all(len(c.tokens) == SERVE["max_new_tokens"] for c in done), "a completion is short")
    require(all(0 <= t < cfg.vocab for c in done for t in c.tokens), "a token outside the vocabulary")
    require(not bool(torch.stack(nan_seen).any()), "NaN in the logits")
    forwards = steps["prefill"] + steps["decode"]
    require(steps["prefill"] == SERVE["n_requests"], "not one prefill a request")
    want = expected(steps["prefill"], forwards)
    require(launches == want, (
        f"{cfg.name}: launches {launches}, expected {want} for {steps['prefill']} prefills and "
        f"{forwards} forward passes: a kernel call went around its kernel"))
    if launches["flash_attention"]:  # bf16 serving: prompts on mma, decode steps on split
        require(attn_paths["fma"] == 0 and attn_paths["mma"] > 0 and attn_paths["split"] > 0,
                f"{cfg.name}: attention paths {attn_paths}, expected mma and split only")
    if launches["mamba2_ssd"]:  # bf16 serving: every prefill layer on the tensor cores
        require(ssd_paths == {"fma": 0, "mma": launches["mamba2_ssd"]},
                f"{cfg.name}: SSD paths {ssd_paths}, expected mma only")
    moe_paths = None
    if cfg.moe is not None:
        # prompts above 256 tokens take the capacity path; the rest, and every
        # decode step at 8 slots, the exact one
        L = cfg.n_layers
        long_prompts = int((lengths > transformer.DENSE_PATH_MAX_TOKENS).sum())
        moe_paths = {"prefills_capacity": moe_calls["prefill"]["capacity"] // L,
                     "prefills_exact": moe_calls["prefill"]["exact"] // L,
                     "decode_steps_exact": moe_calls["decode"]["exact"] // L,
                     "decode_steps_capacity": moe_calls["decode"]["capacity"] // L}
        require(all(n % L == 0 for calls in moe_calls.values() for n in calls.values()),
                f"{cfg.name}: MoE calls {moe_calls} are not whole forward passes")
        require(moe_paths == {"prefills_capacity": long_prompts,
                              "prefills_exact": steps["prefill"] - long_prompts,
                              "decode_steps_exact": steps["decode"],
                              "decode_steps_capacity": 0},
                f"{cfg.name}: MoE paths {moe_paths} for {long_prompts} prompts over 256 tokens")
    snap = server.metrics_snapshot()
    ctx.setdefault("snapshots", {})[cfg.name] = snap
    ctx.setdefault("served", []).append(cfg.name)

    # what the phase adds, then the logit checks on every prompt
    prompts = [("first request", {"tokens": torch.from_numpy(requests[0].prompt[None]).to(dev)},
                scfg.max_len)]
    added = {}
    if extra is not None:
        more, added = extra(ctx, server)
        prompts += more
    checks = {}
    for i, (name, batch, max_len) in enumerate(prompts):
        model32 = None
        if spread is not None and i == 0:   # the float32 check: on the first prompt
            cfg32 = dataclasses.replace(cfg, dtype=torch.float32,
                                        n_layers=fp32_layers or cfg.n_layers)
            model32 = Model(cfg32, attn_impl=server.model.attn_impl, ssd_impl="hopper",
                            device=dev)
            model32.load_state_dict({
                k: v[:cfg32.n_layers] if k.startswith("layers.") else v
                for k, v in server.model.state_dict().items()})
        checks[name] = logit_checks(server.model, batch, max_len, compare_impl, tol, spread,
                                    model32)
        del model32
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    first = checks["first request"]
    bf16 = first["bfloat16"]
    emit(phase, model=cfg.name, family=cfg.family, layers=cfg.n_layers, d_model=cfg.d_model,
         heads=cfg.n_heads, kv_heads=cfg.n_kv_heads, head_dim=cfg.dh, d_ff=cfg.d_ff,
         vocab=cfg.vocab,
         ssm=dict(heads=cfg.ssm_heads, head_dim=cfg.ssm_head_dim, state=cfg.ssm_state,
                  attn_period=cfg.attn_period) if cfg.family in ("ssm", "hybrid") else None,
         moe=dataclasses.asdict(cfg.moe) if cfg.moe is not None else None,
         cuts=cuts or {}, dtype="bfloat16", params=n_params, weights_gb=round(w_gb, 3),
         init_seconds=round(init_s, 3), init_peak_gb=round(init_peak_gb, 3),
         serve_seconds=round(serve_s, 3),
         requests=len(done), prompt_lengths=[int(n) for n in lengths],
         tokens=sum(len(c.tokens) for c in done), prefills=steps["prefill"],
         decode_steps=steps["decode"], kernel_launches=launches, expected_launches=want,
         attention_launches_by_path=attn_paths, ssd_launches_by_path=ssd_paths,
         moe_paths=moe_paths,
         prefill_ms_mean=round(float(np.mean(step_ms["prefill"])), 3),
         decode_step_ms_mean=round(float(np.mean(step_ms["decode"])), 3),
         decode_step_ms_p50=round(float(np.median(step_ms["decode"])), 3),
         decode_step_ms_min=round(float(np.min(step_ms["decode"])), 3),
         decode_step_ms_all=[round(t, 1) for t in step_ms["decode"]],
         peak_memory_gb=round(peak_gb, 3), tokens_per_s=snap["tokens_per_s"],
         latency_ms_p50=snap["latency_ms"]["p50"], latency_ms_p99=snap["latency_ms"]["p99"],
         compared_with=compare_impl, logits_max_abs=first["logits_max_abs"],
         prefill_logits_err=bf16["prefill_err"], decode_logits_err=bf16["decode_err"],
         argmax_agrees=bf16["argmax_agrees"], tolerance=bf16["tolerance"],
         tolerance_reason=why, checks=first,
         more_checks={k: v for k, v in checks.items() if k != "first request"}, **added,
         card=ctx.get("card"), first_completion=done[0].tokens[:8])
    for name, check in checks.items():
        require(check["bfloat16"]["within"],
                f"{cfg.name}, {name}: kernel path and plain path disagree on the logits")
        if "float32" in check:
            require(check["float32"]["within"] and all(check["float32"]["argmax_agrees"]),
                    f"{cfg.name}, {name}: kernel path and plain path disagree on the float32 "
                    f"logits")
    if ctx.get("profile"):
        profile_server(ctx, server)
    # the next phase starts with an empty card: this one's weights go
    del server
    gc.collect()
    torch.cuda.empty_cache()


def phase_serve(ctx):
    cfg = get_config("stablelm_3b")
    serve_path(
        ctx, "serve", "stablelm_3b",
        lambda prefills, forwards: {"flash_attention": cfg.n_layers * forwards, "mamba2_ssd": 0},
        {"attn_impl": "chunked"}, 1e-1,
        "bf16 through 32 layers: logits of magnitude ~4 are spaced 0.03 apart and the two "
        "paths round each layer's attention output on their own, so one to two spacings of "
        "difference are expected; 1e-1 (absolute + relative) allows three")


SSD_WHY = ("the kernel and ssd_chunked both return fp32 y, summed in another order (64-row "
           "against 256-row chunks); one rounding of y to bf16 in a layer may then fall the "
           "other way, and such one-ulp differences carry through the layers; 1e-1 as in the "
           "dense path, or twice the spread of ssd_chunked against itself at chunk 64, "
           "which moves only roundings, where that is larger")


def ssd_spread(arch):
    """``ssd_chunked`` at chunk 64: the same function, other roundings."""
    return {"cfg": dataclasses.replace(get_config(arch), ssm_chunk=64), "ssd_impl": "chunked"}


def phase_serve_mamba2(ctx):
    cfg = get_config("mamba2_370m")
    serve_path(ctx, "serve_mamba2", "mamba2_370m",
               lambda prefills, forwards: {"flash_attention": 0,
                                           "mamba2_ssd": cfg.n_layers * prefills},
               {"ssd_impl": "chunked"}, 1e-1, SSD_WHY, ssd_spread("mamba2_370m"))


def phase_serve_zamba2(ctx):
    from repro_torch.models.hybrid import n_attn_applications

    cfg = get_config("zamba2_2_7b")
    apps = n_attn_applications(cfg)
    serve_path(ctx, "serve_zamba2", "zamba2_2_7b",
               lambda prefills, forwards: {"flash_attention": apps * forwards,
                                           "mamba2_ssd": cfg.n_layers * prefills},
               {"ssd_impl": "chunked"}, 1e-1, SSD_WHY, ssd_spread("zamba2_2_7b"))


ATTN_WHY = ("bf16: the kernel and attention_chunked round each layer's attention output on "
            "their own, and a token whose top-k routing is a near tie may then take another "
            "expert on the two paths; 1e-1 as in the dense path, or twice the spread of "
            "attention 'xla' against 'chunked' (the same function, other roundings) where that "
            "is larger")
ATTN_SPREAD = {"attn_impl": "xla"}


def attention_launches(layers):
    return lambda prefills, forwards: {"flash_attention": layers * forwards, "mamba2_ssd": 0}


def phase_serve_qwen2_moe(ctx):
    """qwen2_moe_a2_7b at full width and depth; the float32 check at 2 of its
    24 layers (53 GiB in float32 would not fit beside the bf16 copy)."""
    serve_path(ctx, "serve_qwen2_moe", "qwen2_moe_a2_7b",
               attention_launches(get_config("qwen2_moe_a2_7b").n_layers),
               {"attn_impl": "chunked"}, 1e-1, ATTN_WHY, ATTN_SPREAD, fp32_layers=2)


#: qwen2_vl_2b's vision prefix: 256 patches of a 16 x 16 grid
N_PATCHES, GRID = 256, 16


def vision_prefix(ctx, server):
    """A 512-token prompt whose first 256 embeddings are seeded bf16 patch
    embeddings, with M-RoPE positions (patch ``i`` at ``(0, i // 16, i % 16)``,
    text token ``j`` at ``16 + j`` on all three streams), prefilled through
    ``Model.prefill``, then 8 greedy decode steps with 1-D positions, as the
    reference decodes; every layer of every pass through the kernel."""
    model, cfg = server.model, server.model.cfg
    rng = np.random.default_rng(SERVE["seed"] + 7)
    S = 512
    pos = np.zeros((1, S, 3), np.int32)
    i = np.arange(N_PATCHES)
    pos[0, :N_PATCHES] = np.stack([np.zeros_like(i), i // GRID, i % GRID], -1)
    pos[0, N_PATCHES:] = (GRID + np.arange(S - N_PATCHES))[:, None]
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, size=(1, S))).to(DEVICE),
             "patch_embeds": torch.from_numpy(rng.standard_normal(
                 (1, N_PATCHES, cfg.d_model), dtype=np.float32)).to(DEVICE).bfloat16(),
             "mrope_positions": torch.from_numpy(pos).to(DEVICE)}
    reset_counts()
    h, state = model.prefill(batch, SERVE["max_len"])
    tokens = [model.logits(h[:, -1:])[:, 0].argmax(-1, keepdim=True)]
    for _ in range(8):
        h, state = model.decode_step(tokens[-1], state)
        tokens.append(model.logits(h[:, -1:])[:, 0].argmax(-1, keepdim=True))
    torch.cuda.synchronize()
    launches, paths = read_counts(), dict(fa.flash_attention.launches_by_path)
    ctx["launches"]["serve_qwen2_vl:vision_prefix"] = launches
    ctx["attention_paths"]["serve_qwen2_vl:vision_prefix"] = paths
    want = {"flash_attention": cfg.n_layers * 9, "mamba2_ssd": 0}
    require(launches == want and paths == {"fma": 0, "mma": cfg.n_layers,
                                           "split": 8 * cfg.n_layers},
            f"vision prefix: launches {launches} by path {paths}, expected {want}")
    require(int(state["pos"][0]) == S + 8, "vision prefix: decode positions")
    return ([("vision prefix", batch, SERVE["max_len"])],
            {"vision_prefix": {"prompt": S, "patches": N_PATCHES, "grid": [GRID, GRID],
                               "decode_steps": 8, "kernel_launches": launches,
                               "attention_launches_by_path": paths,
                               "tokens": [int(t) for t in torch.cat(tokens).flatten()]}})


def phase_serve_qwen2_vl(ctx):
    """qwen2_vl_2b at full width and depth, with its vision-prefix prefill."""
    serve_path(ctx, "serve_qwen2_vl", "qwen2_vl_2b",
               attention_launches(get_config("qwen2_vl_2b").n_layers),
               {"attn_impl": "chunked"}, 1e-1, ATTN_WHY, ATTN_SPREAD, extra=vision_prefix)


#: llama4_scout at full width, 4 of its 48 layers: one global period (three
#: chunked RoPE layers, one global NoPE layer); 48 layers are 200.7 GiB in bf16
LLAMA4_CUTS = {"n_layers": 4}
LONG_PROMPT, LONG_MAX_LEN = 8448, 8704


def long_prompt(ctx, server):
    """One prompt of 8,448 tokens, across the 8,192-token attention chunk,
    through a server of one slot with room for 8,704: a prefill (the
    capacity path of every MoE layer) and 4 decode steps."""
    cfg = server.model.cfg
    rng = np.random.default_rng(SERVE["seed"] + 11)
    prompt = rng.integers(0, cfg.vocab, size=LONG_PROMPT).astype(np.int32)
    one = Server(cfg, ServeConfig(batch_slots=1, max_len=LONG_MAX_LEN, max_new_tokens=5, eos=-1),
                 server.model.state_dict(), device=DEVICE)
    step_ms = []
    prefill = one._prefill

    def timed(*args):
        t = time.perf_counter()
        out = prefill(*args)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        return out

    one._prefill = timed
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_counts()
    t0 = time.perf_counter()
    done = one.serve([Request(uid=0, prompt=prompt)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, paths = read_counts(), dict(fa.flash_attention.launches_by_path)
    ctx["launches"]["serve_llama4:long_prompt"] = launches
    ctx["attention_paths"]["serve_llama4:long_prompt"] = paths
    L = cfg.n_layers
    want = {"flash_attention": L * 5, "mamba2_ssd": 0}
    require(launches == want and paths == {"fma": 0, "mma": L, "split": 4 * L},
            f"long prompt: launches {launches} by path {paths}, expected {want}")
    require(len(done[0].tokens) == 5 and len(step_ms) == 1, "long prompt: not 5 tokens")
    del one, prefill, timed
    return ([("8,448-token prompt", {"tokens": torch.from_numpy(prompt[None]).to(DEVICE)},
              LONG_MAX_LEN)],
            {"long_prompt": {"tokens_in": LONG_PROMPT, "max_len": LONG_MAX_LEN,
                             "attn_chunk": cfg.attn_chunk, "decode_steps": 4,
                             "kernel_launches": launches, "attention_launches_by_path": paths,
                             "seconds": round(seconds, 3),
                             "prefill_ms": round(step_ms[0], 3),
                             "peak_memory_gb": round(
                                 (torch.cuda.max_memory_allocated() - base) / 2**30, 3),
                             "tokens": done[0].tokens}})


def phase_serve_llama4(ctx):
    """llama4_scout_17b_a16e at full width and 4 of 48 layers, with one
    8,448-token prompt; the float32 check at all 4 layers."""
    serve_path(ctx, "serve_llama4", "llama4_scout_17b_a16e",
               attention_launches(LLAMA4_CUTS["n_layers"]), {"attn_impl": "chunked"}, 1e-1,
               ATTN_WHY, ATTN_SPREAD, cuts=LLAMA4_CUTS, extra=long_prompt)


#: whisper_large_v3's decode: 8 slots of 1,500 frames (30 s), 32 greedy steps
#: from position 0 into a 448-slot cache (the decoder's maximum position),
#: starting from token 50258 (Whisper's start of transcript); the logit
#: checks over the prefill and 4 steps, the float32 one at 2 of 32 layers
WHISPER = dict(slots=8, frames=1500, steps=32, max_len=448, start=50258, check_steps=4,
               fp32_layers=2, seed=0)
WHISPER_WHY = ("bf16 through 32 + 32 layers: the kernel and attention_chunked round each "
               "attention output on their own; 1e-1 as in serve, or twice the spread of "
               "attention 'xla' against 'chunked' (the same function, other roundings) where "
               "that is larger")


def whisper_frames(cfg):
    """The 8 slots' frame embeddings (the frontend stub's output): seeded,
    bf16, on the card."""
    rng = np.random.default_rng(WHISPER["seed"])
    x = rng.standard_normal((WHISPER["slots"], WHISPER["frames"], cfg.d_model), dtype=np.float32)
    return torch.from_numpy(x).to(DEVICE).to(cfg.dtype)


def whisper_decode(model, frames, steps, tokens=None, step_ms=None):
    """``Model.prefill`` of ``frames`` (the prompt's tokens give only the batch
    size, as in the reference), then ``steps`` decode steps from position 0,
    fed ``tokens[i]`` where given, else greedy from the start token.  Returns
    (encoder output, [float32 logits of each step], [tokens fed]); with
    ``step_ms`` each step's wall time is appended, the prefill's first."""
    B = frames.shape[0]
    t = time.perf_counter()
    enc, state = model.prefill({"tokens": torch.zeros((B, 1), dtype=torch.int64, device=DEVICE),
                                "frame_embeds": frames}, WHISPER["max_len"])
    if step_ms is not None:
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
    tok = torch.full((B, 1), WHISPER["start"], dtype=torch.int64, device=DEVICE)
    logits, fed = [], []
    for i in range(steps):
        t = time.perf_counter()
        tok = tokens[i] if tokens is not None else tok
        fed.append(tok)
        h, state = model.decode_step(tok, state)
        out = model.logits(h[:, -1:])[:, 0].float()
        tok = out.argmax(-1, keepdim=True)
        if step_ms is not None:
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t) * 1e3)
        logits.append(out)
    return enc, logits, fed


def whisper_agreement(got, want, tol):
    """Largest error of the encoder output and of each step's logits, and
    whether each step picks the same tokens."""
    enc_err, ok_enc = compare(got[0], want[0], tol)
    errs = [compare(g, w, tol) for g, w in zip(got[1], want[1])]
    return {"encoder_err": enc_err, "logits_err": max(e for e, _ in errs),
            "logits_err_by_step": [e for e, _ in errs],
            "argmax_agrees": [bool((g.argmax(-1) == w.argmax(-1)).all())
                              for g, w in zip(got[1], want[1])],
            "within": ok_enc and all(ok for _, ok in errs)}


def whisper_checks(model, frames):
    """The kernel path (``attn_impl="hopper"``: all three attentions) against
    ``"chunked"`` over the prefill and the first decode steps, both fed the
    chunked path's greedy tokens: in bf16 within max(1e-1, twice the spread
    of ``"xla"`` against ``"chunked"``); the same weights in float32 at 2
    layers within 1e-3 with the same tokens."""
    n = WHISPER["check_steps"]

    def run(m, impl, tokens=None, x=frames):
        m.attn_impl = impl
        try:
            return whisper_decode(m, x, n, tokens)
        finally:
            m.attn_impl = "hopper"

    plain = run(model, "chunked")
    spread = whisper_agreement(run(model, "xla", plain[2]), plain, 0.0)
    tol = max(1e-1, 2 * max(spread["encoder_err"], spread["logits_err"]))
    checks = {"plain_vs_itself": {"changed": {"attn_impl": "xla"}, **spread},
              "bfloat16": {"tolerance": tol, **whisper_agreement(run(model, "hopper", plain[2]),
                                                                 plain, tol)}}
    del plain
    L = WHISPER["fp32_layers"]
    cfg32 = dataclasses.replace(model.cfg, dtype=torch.float32, n_layers=L)
    model32 = Model(cfg32, attn_impl="hopper", device=DEVICE)
    model32.load_state_dict({k: v[:L] if k.startswith(("enc.", "dec.")) else v
                             for k, v in model.state_dict().items()})
    x32 = frames.float()
    plain32 = run(model32, "chunked", x=x32)
    checks["float32"] = {"tolerance": 1e-3, "layers": L,
                         **whisper_agreement(run(model32, "hopper", plain32[2], x32), plain32,
                                             1e-3)}
    del model32, plain32
    torch.cuda.empty_cache()
    return checks


def phase_serve_whisper(ctx):
    """whisper_large_v3 at full width and depth through ``Model.prefill`` /
    ``decode_step`` (the reference's ``Server`` cannot take frames): every
    attention through the kernel, counted by path; then the logit checks."""
    cfg = get_config("whisper_large_v3")
    base_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model(cfg, attn_impl="hopper", device=DEVICE).init(seed=WHISPER["seed"])
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak_gb = (torch.cuda.max_memory_allocated() - base_bytes) / 2**30
    w_gb = weights_gb(model)
    require(init_peak_gb <= w_gb + 4.0, f"{cfg.name}: initialisation peak "
            f"{init_peak_gb:.2f} GiB over {w_gb:.2f} GiB of weights")
    frames = whisper_frames(cfg)
    whisper_decode(model, frames[:1], 2)     # warm-up outside the measured run
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    reset_counts()                  # the path starts here
    enc, logits, fed = whisper_decode(model, frames, WHISPER["steps"], step_ms=step_ms)
    torch.cuda.synchronize()
    launches = read_counts()        # ... and ends here
    paths = dict(fa.flash_attention.launches_by_path)
    peak_gb = (torch.cuda.max_memory_allocated() - base_bytes) / 2**30
    ctx.setdefault("launches", {})["serve_whisper"] = launches
    ctx.setdefault("attention_paths", {})["serve_whisper"] = paths
    L, n = cfg.n_layers, WHISPER["steps"]
    # the encoder: one self-attention a layer (mma); a decode step: one
    # self-attention and one cross-attention a decoder layer (split)
    want = {"flash_attention": L + n * 2 * L, "mamba2_ssd": 0}
    want_paths = {"fma": 0, "mma": L, "split": n * 2 * L}
    require(launches == want and paths == want_paths,
            f"{cfg.name}: launches {launches} by path {paths}, expected {want} by path "
            f"{want_paths}: an attention call went around its kernel")
    stacked = torch.stack(logits)
    require(bool(torch.isfinite(stacked).all()) and bool(torch.isfinite(enc.float()).all()),
            "whisper: non-finite encoder output or logits")
    tokens = torch.cat(fed[1:] + [stacked[-1].argmax(-1, keepdim=True)], dim=1)
    require(bool(((tokens >= 0) & (tokens < cfg.vocab)).all()), "a token outside the vocabulary")
    require(enc.shape == (WHISPER["slots"], WHISPER["frames"], cfg.d_model), "encoder output shape")
    checks = whisper_checks(model, frames)
    decode_ms = step_ms[1:]
    decode_s = sum(decode_ms) / 1e3
    emit("serve_whisper", model=cfg.name, family=cfg.family, layers=[L, L], d_model=cfg.d_model,
         heads=cfg.n_heads, kv_heads=cfg.n_kv_heads, head_dim=cfg.dh, d_ff=cfg.d_ff,
         vocab=cfg.vocab, cuts={}, dtype="bfloat16", params=sum(p.numel() for p in model.parameters()),
         weights_gb=round(w_gb, 3), init_seconds=round(init_s, 3),
         init_peak_gb=round(init_peak_gb, 3), slots=WHISPER["slots"], frames=WHISPER["frames"],
         decode_steps=n, max_len=WHISPER["max_len"], kernel_launches=launches,
         expected_launches=want, attention_launches_by_path=paths,
         prefill_ms=round(step_ms[0], 3), decode_step_ms_mean=round(float(np.mean(decode_ms)), 3),
         decode_step_ms_p50=round(float(np.median(decode_ms)), 3),
         decode_step_ms_min=round(float(np.min(decode_ms)), 3),
         decode_step_ms_all=[round(t, 1) for t in decode_ms],
         tokens_per_s_decode=WHISPER["slots"] * n / decode_s,
         tokens_per_s=WHISPER["slots"] * n / (decode_s + step_ms[0] / 1e3),
         peak_memory_gb=round(peak_gb, 3), compared_with={"attn_impl": "chunked"},
         logits_max_abs=float(stacked.abs().max()),
         logits_err=checks["bfloat16"]["logits_err"],
         encoder_err=checks["bfloat16"]["encoder_err"],
         tolerance=checks["bfloat16"]["tolerance"], tolerance_reason=WHISPER_WHY, checks=checks,
         card=ctx.get("card"), first_tokens=[int(t) for t in tokens[0, :8]])
    require(checks["bfloat16"]["within"],
            f"{cfg.name}: kernel path and plain path disagree on the logits")
    require(checks["float32"]["within"] and all(checks["float32"]["argmax_agrees"]),
            f"{cfg.name}: kernel path and plain path disagree on the float32 logits")
    ctx.setdefault("served", []).append(cfg.name)
    if ctx.get("profile"):
        profile_whisper(ctx, model, frames)
    del model, enc, logits
    gc.collect()
    torch.cuda.empty_cache()


#: the training phase: stablelm_3b, 8 steps of 8 x 512 tokens
TRAIN = dict(arch="stablelm_3b", seq_len=512, global_batch=8, data_seed=7, steps=8,
             restart_layers=2, checkpoint_every=4, fail_at=5, check_layers=2)
#: the MoE restart: qwen2_moe_a2_7b at full width and 2 layers, 8 x 512 =
#: 4,096 tokens a batch (the capacity path); its checkpoint (weights and
#: float32 moments, about 18 GB) is written twice a run, so the run is short
MOE_RESTART = dict(arch="qwen2_moe_a2_7b", layers=2, steps=4, checkpoint_every=2, fail_at=3)


def dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


def restart_run(cfg, opt, data, tmp, steps, checkpoint_every, fail_at):
    """An uninterrupted run and one that fails at ``fail_at`` and restarts
    from its latest checkpoint, on ``cfg``: both must end bit for bit (loss,
    parameters, moments).  Returns the record."""
    import shutil

    from repro_torch.runtime import TrainConfig, Trainer

    runs, ckpt_bytes = {}, {}
    for name in ("uninterrupted", "interrupted"):
        armed = {"on": name == "interrupted"}

        def injector(step, armed=armed):
            if step == fail_at and armed["on"]:
                armed["on"] = False
                raise RuntimeError("injected node failure")

        # one checkpoint kept, each run's removed after it
        tr = Trainer(cfg, opt, TrainConfig(steps=steps, checkpoint_every=checkpoint_every,
                                           checkpoint_dir=os.path.join(tmp, name),
                                           keep_checkpoints=1, remat="full",
                                           attn_impl="chunked"),
                     data, device=DEVICE)
        runs[name] = tr.run(fault_injector=injector)
        ckpt_bytes[name] = dir_bytes(tr.ckpt._path(tr.ckpt.latest_step()))
        shutil.rmtree(os.path.join(tmp, name), ignore_errors=True)
        del tr
    a, b = runs["uninterrupted"], runs["interrupted"]
    params_equal = all(torch.equal(p, b["params"][k]) for k, p in a["params"].items())
    moments_equal = all(torch.equal(m, b["opt_state"][part][k]) for part in ("mu", "nu")
                        for k, m in a["opt_state"][part].items())
    first = next((k for k, p in a["params"].items() if not torch.equal(p, b["params"][k])),
                 None)
    out = {"arch": cfg.name, "layers": cfg.n_layers, "steps": steps,
           "checkpoint_every": checkpoint_every, "fail_at": fail_at, "restarts": b["restarts"],
           "resumed_from_step": fail_at + steps - len(b["losses"]),
           "losses_uninterrupted": a["losses"], "losses_interrupted": b["losses"],
           "final_loss_equal": a["losses"][-1] == b["losses"][-1],
           "params_bit_equal": params_equal, "moments_bit_equal": moments_equal,
           "first_different_leaf": first, "checkpoint_bytes": ckpt_bytes["uninterrupted"]}
    require(a["restarts"] == 0 and b["restarts"] == 1, f"train: restarts ({cfg.name})")
    # steps 0 .. fail_at - 1, then every step from the last checkpoint on, again
    resumed = fail_at // checkpoint_every * checkpoint_every
    require(len(b["losses"]) == fail_at + steps - resumed,
            f"train: the restarted run did not resume from step {resumed} ({cfg.name})")
    require(a["losses"][-1] == b["losses"][-1] and params_equal and moments_equal,
            f"train: the restarted run does not end where the uninterrupted run ends: {out}")
    return out


def phase_train(ctx):
    """``Trainer`` on the card.  No kernel runs: the CUDA kernels are
    forward only (their wrappers raise under grad), so training goes
    through ``attention_chunked`` in PyTorch; the launch counts must stay 0.
    (a) full width and depth, remat "full", no checkpoint: the loss must
    fall; (b) full width, 2 of 32 layers (a 32-layer checkpoint with float32
    moments is about 28 GB): a run that fails at step 5 and restarts from
    its step-4 checkpoint must end with the uninterrupted run's loss and
    parameters and moments, bit for bit, and so must qwen2_moe_a2_7b's at
    2 layers through the MoE capacity path (:data:`MOE_RESTART`); (c)
    float32 at 2 layers: the gradients through "chunked" against "xla"
    within 1e-4 of their norm."""
    import shutil
    import tempfile

    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.optim import AdamWConfig, global_norm
    from repro_torch.runtime import TrainConfig, Trainer

    cfg = get_config(TRAIN["arch"])
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=TRAIN["steps"])
    data = DataConfig(vocab=cfg.vocab, seq_len=TRAIN["seq_len"],
                      global_batch=TRAIN["global_batch"], seed=TRAIN["data_seed"])
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    out = {"arch": cfg.name, "card": ctx.get("card"),
           "kernel": "none: the CUDA kernels are forward only; training runs attention_chunked "
                     "in PyTorch (cuBLAS products)",
           "data": dataclasses.asdict(data), "optimizer": dataclasses.asdict(opt)}
    try:
        # (a) full width and depth
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        tr = Trainer(cfg, opt, TrainConfig(steps=TRAIN["steps"], checkpoint_every=0,
                                           checkpoint_dir=os.path.join(tmp, "a"), remat="full",
                                           attn_impl="chunked"), data, device=DEVICE)
        t0 = time.perf_counter()
        run = tr.run()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_counts()
        require(launches == {"flash_attention": 0, "mamba2_ssd": 0},
                f"train: a forward-only kernel was launched: {launches}")
        losses = run["losses"]
        state_gb = sum(t.numel() * t.element_size() for part in (run["params"],
                       run["opt_state"]["mu"], run["opt_state"]["nu"]) for t in part.values())
        steady = run["step_seconds"][1:]
        out["full"] = {
            "layers": cfg.n_layers, "params": sum(p.numel() for p in run["params"].values()),
            "remat": "full", "attn_impl": "chunked", "steps": len(losses), "seconds": seconds,
            "step_ms": [round(t * 1e3, 3) for t in run["step_seconds"]],
            "step_ms_p50_after_first": float(np.median(steady)) * 1e3,
            "tokens_per_s": TRAIN["seq_len"] * TRAIN["global_batch"] / float(np.median(steady)),
            "losses": losses, "params_and_moments_gb": state_gb / 2**30,
            "peak_memory_gb": (torch.cuda.max_memory_allocated() - base) / 2**30,
            "kernel_launches": launches}
        ctx["train_full"] = out["full"]
        require(len(losses) == TRAIN["steps"] and all(np.isfinite(losses)), "train: losses")
        require(losses[-1] < losses[0], f"train: the loss did not fall: {losses}")
        del tr, run
        gc.collect()
        torch.cuda.empty_cache()

        # (b) restart, bit for bit (a checkpoint of about 4 GB); then the MoE's,
        # past its capacity path
        cfg2 = dataclasses.replace(cfg, n_layers=TRAIN["restart_layers"])
        out["restart"] = restart_run(cfg2, opt, data, tmp, TRAIN["steps"],
                                     TRAIN["checkpoint_every"], TRAIN["fail_at"])
        gc.collect()
        torch.cuda.empty_cache()
        m = MOE_RESTART
        moe = dataclasses.replace(get_config(m["arch"]), n_layers=m["layers"])
        require(TRAIN["seq_len"] * TRAIN["global_batch"] > transformer.DENSE_PATH_MAX_TOKENS,
                "train: the MoE restart must take the capacity path")
        moe_opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=m["steps"])
        moe_data = dataclasses.replace(data, vocab=moe.vocab)
        out["restart_moe"] = restart_run(moe, moe_opt, moe_data, tmp, m["steps"],
                                         m["checkpoint_every"], m["fail_at"])
        out["restart_moe"]["tokens_a_batch"] = TRAIN["seq_len"] * TRAIN["global_batch"]
        gc.collect()
        torch.cuda.empty_cache()

        # (c) float32: gradients through "chunked" against "xla"
        cfg32 = dataclasses.replace(cfg, n_layers=TRAIN["check_layers"], dtype=torch.float32)
        model = Model(cfg32, device=DEVICE).init(seed=0)
        for p in model.parameters():
            p.requires_grad_(True)
        batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in SyntheticLM(data).batch(0).items()}
        grads, loss = {}, {}
        for impl in ("chunked", "xla"):
            model.attn_impl = impl
            value = model.train_loss(batch)
            grads[impl] = dict(zip([k for k, _ in model.named_parameters()],
                                   torch.autograd.grad(value, list(model.parameters()))))
            loss[impl] = float(value.detach())
        norm = float(global_norm(grads["xla"]))
        err = max(float((grads["chunked"][k] - g).abs().max()) for k, g in grads["xla"].items())
        out["float32"] = {"layers": cfg32.n_layers, "loss_chunked": loss["chunked"],
                          "loss_xla": loss["xla"], "grad_norm": norm, "grad_err": err,
                          "grad_err_relative": err / norm, "tolerance": 1e-4}
        require(abs(loss["chunked"] - loss["xla"]) <= 1e-5 * max(1.0, abs(loss["xla"]))
                and err <= 1e-4 * norm, f"train: float32 chunked against xla: {out['float32']}")
        del model, grads
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    emit("train", **out)


# ---------------------------------------------------------------------------
# the mesh, the dry-run and the variant selector
# ---------------------------------------------------------------------------

ROOT = os.path.dirname(os.path.abspath(__file__))
TRAIN_MESH = dict(check_layers=2, check_steps=3, elastic_layers=2, elastic_steps=2)
#: the dryrun phase's sweeps, one process each: every stablelm_3b cell on the
#: card's one-rank mesh; qwen2_7b and llama4 (its 16 experts take expert
#: parallelism; both have too few KV heads for the model axis, so their
#: caches shard the sequence, and heads that 16 does not divide, so their
#: attention is whole), stablelm_3b train_4k (every product split), and
#: mamba2_370m (SSM heads split, vocabulary whole), zamba2_2_7b (nearly all
#: split) and whisper_large_v3 (MLP split, its 20 heads whole) train_4k /
#: decode_32k on the 16 x 16 production mesh
DRYRUN = {
    "stablelm_1gpu": ["--arch", "stablelm_3b", "--mesh", "1gpu"],
    "qwen2_7b_16x16": ["--arch", "qwen2_7b", "--shape", "train_4k,decode_32k", "--mesh", "single"],
    "llama4_16x16": ["--arch", "llama4_scout_17b_a16e", "--shape", "train_4k,decode_32k",
                     "--mesh", "single"],
    "stablelm_16x16": ["--arch", "stablelm_3b", "--shape", "train_4k", "--mesh", "single"],
    "mamba2_16x16": ["--arch", "mamba2_370m", "--shape", "train_4k,decode_32k", "--mesh",
                     "single"],
    "zamba2_16x16": ["--arch", "zamba2_2_7b", "--shape", "train_4k,decode_32k", "--mesh",
                     "single"],
    "whisper_16x16": ["--arch", "whisper_large_v3", "--shape", "train_4k,decode_32k", "--mesh",
                      "single"],
}
#: the 16 x 16 cells the dryrun phase holds to :func:`shape_flops`
SPLIT_CELLS = 11
#: the select phase's cell (the train phase's 8 x 512 tokens) and variants
SELECT = dict(remats=("none", "dots", "full"), microbatches=(1, 4), warmup=1, timed=3)
RECORD_KEYS = ("arch", "shape", "mesh", "kind", "seq_len", "global_batch", "remat", "fsdp",
               "microbatches", "mode", "status")


def _subprocess_env():
    return {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"), "OMP_NUM_THREADS": "1"}


def start_dryruns(ctx):
    """Start every dry-run the dryrun and select phases read, all at once,
    each in a process of its own (a process holds one process group, and
    theirs is the fake one): they run on meta tensors on the host's cores
    while the card trains.  Idempotent; the processes end with the run."""
    if "dryruns" in ctx:
        return ctx["dryruns"]
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    sweeps = dict(DRYRUN)
    for remat in SELECT["remats"]:
        sweeps[f"select_{remat}"] = [
            "--arch", TRAIN["arch"], "--shape", "train_4k", "--seq-len", str(TRAIN["seq_len"]),
            "--global-batch", str(TRAIN["global_batch"]), "--mesh", "1gpu", "--remat", remat,
            "--microbatches", ",".join(map(str, SELECT["microbatches"]))]
    jobs = {}
    for name, args in sweeps.items():
        out, log = os.path.join(tmp, f"{name}.json"), open(os.path.join(tmp, f"{name}.log"), "w")
        proc = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun", *args,
                                 "--out", out], cwd=ROOT, env=_subprocess_env(), stdout=log,
                                stderr=subprocess.STDOUT)
        jobs[name] = dict(proc=proc, out=out, log=log, args=args)
    ctx["dryruns"] = dict(dir=tmp, jobs=jobs, started=time.perf_counter())
    ctx.setdefault("processes", []).extend(j["proc"] for j in jobs.values())
    return ctx["dryruns"]


def dryrun_records(ctx, name, timeout=900):
    """The records of one dry-run sweep, once its process has ended (it
    must end with 0: a failing cell is a record, not a crash)."""
    job = start_dryruns(ctx)["jobs"][name]
    rc = job["proc"].wait(timeout=timeout)
    job["log"].close()
    with open(job["log"].name) as f:
        tail = f.read()[-3000:]
    require(rc == 0 and os.path.exists(job["out"]), f"dryrun {name} exited {rc}: {tail}")
    with open(job["out"]) as f:
        records = json.load(f)
    for rec in records:
        require(all(k in rec for k in RECORD_KEYS), f"dryrun {name}: record keys {sorted(rec)}")
    return records, time.perf_counter() - ctx["dryruns"]["started"]


def host_mesh(ctx):
    """This process's rank of a one-rank NCCL group (file store) and the
    (data=1, model=1) mesh over it; the group ends with the run."""
    if "mesh" not in ctx:
        import tempfile

        from repro_torch.launch.mesh import make_host_mesh, start_process_group

        tmp = tempfile.mkdtemp(prefix="chip_smoke_group_")
        ctx.setdefault("tmp_dirs", []).append(tmp)
        start_process_group("cuda", 0, 1, os.path.join(tmp, "store"))
        ctx["mesh"] = make_host_mesh()
    return ctx["mesh"]


def _full(t):
    from torch.distributed.tensor import DTensor

    return (t.full_tensor() if isinstance(t, DTensor) else t).detach()


class _OpLog(TorchDispatchMode):
    """Each non-view op's name and the float64 sum of its first output."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        first = out[0] if isinstance(out, (tuple, list)) and out else out
        if (not func.is_view and isinstance(first, torch.Tensor) and first.numel()
                and first.dtype.is_floating_point):
            self.ops.append((str(func), float(first.double().sum())))
        return out


def first_different_op(tr_mesh, tr_plain, batch):
    """Where two trainers' first gradient computations part: both traced op by
    op (names and output sums), the first pair that differs."""
    from repro_torch.runtime.trainer import loss_and_grads

    logs = []
    for tr in (tr_mesh, tr_plain):
        params, _ = tr.init_state()
        with _OpLog() as log:
            loss_and_grads(tr.model, params, tr._put_batch(batch), tr.mesh, tr._shardings)
        logs.append(log.ops)
    for i, (a, b) in enumerate(zip(*logs)):
        if a != b:
            return {"index": i, "meshed": a, "plain": b}
    return {"index": None, "ops": [len(logs[0]), len(logs[1])]}


def phase_train_mesh(ctx):
    """The meshed trainer on the card's one-rank NCCL mesh (data=1, model=1).
    (a) ``python -m repro_torch.launch.train ... --fsdp`` as a subprocess:
    stablelm_3b at full width and depth, the train phase's data, optimizer
    and remat, 8 x 512 tokens (attention by ``--seq-len``, as the reference's
    CLI: ``xla``); reported beside the train phase's un-meshed run.  (b)
    float32 at 2 layers, 3 steps: the meshed trainer (fsdp) against the
    un-meshed one, within 1e-6 relative, stablelm_3b and mamba2_370m; bit
    for bit expected, and if not, the first op that differs is named.  (c) elastic restore at 2 layers:
    saved under the fsdp mesh at step 2, restored by a trainer without fsdp
    after ``remesh`` to the mesh: parameters and moments bit for bit.  No
    kernel runs (the kernels are forward only)."""
    import shutil
    import tempfile

    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import TrainConfig, Trainer

    start_dryruns(ctx)
    cfg = get_config(TRAIN["arch"])
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    out = {"arch": cfg.name, "card": ctx.get("card"), "mesh": {"data": 1, "model": 1},
           "backend": "nccl"}
    try:
        # (a) the CLI
        t0 = time.perf_counter()
        cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", TRAIN["arch"],
               "--steps", str(TRAIN["steps"]), "--global-batch", str(TRAIN["global_batch"]),
               "--seq-len", str(TRAIN["seq_len"]), "--lr", "1e-3", "--warmup-steps", "2",
               "--data-seed", str(TRAIN["data_seed"]), "--remat", "full", "--fsdp",
               "--ckpt-every", "0", "--ckpt-dir", os.path.join(tmp, "cli")]
        proc = subprocess.run(cmd, cwd=ROOT, env=_subprocess_env(), capture_output=True,
                              text=True, timeout=900)
        require(proc.returncode == 0, f"train CLI exited {proc.returncode}: {proc.stderr[-3000:]}")
        cli = json.loads(proc.stdout.strip().splitlines()[-1])
        steady = cli["step_seconds"][1:]
        out["cli"] = {"command": " ".join(cmd[1:]), "seconds": time.perf_counter() - t0,
                      "attn_impl": "xla", "losses": cli["losses"],
                      "step_ms": [t * 1e3 for t in cli["step_seconds"]],
                      "step_ms_p50_after_first": float(np.median(steady)) * 1e3,
                      "tokens_per_s": TRAIN["seq_len"] * TRAIN["global_batch"]
                      / float(np.median(steady)),
                      "peak_memory_gb": cli["peak_memory_gb"], "mesh": cli["mesh"],
                      "kernel_launches": cli["kernel_launches"]}
        out["unmeshed_train_phase"] = {k: ctx.get("train_full", {}).get(k) for k in (
            "attn_impl", "losses", "step_ms_p50_after_first", "tokens_per_s", "peak_memory_gb")}
        require(len(cli["losses"]) == TRAIN["steps"] and all(np.isfinite(cli["losses"]))
                and cli["losses"][-1] < cli["losses"][0], f"train_mesh: CLI losses {cli['losses']}")
        require(cli["kernel_launches"] == {"flash_attention": 0, "mamba2_ssd": 0},
                f"train_mesh: the CLI launched a kernel: {cli['kernel_launches']}")

        mesh = host_mesh(ctx)
        reset_counts()
        opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=TRAIN["steps"])
        data = DataConfig(vocab=cfg.vocab, seq_len=TRAIN["seq_len"],
                          global_batch=TRAIN["global_batch"], seed=TRAIN["data_seed"])

        # (b) float32, 2 layers: meshed against un-meshed, a transformer and a
        # mamba stack (the plan of a 1-wide axis is WHOLE in both)
        for key, arch in (("float32", TRAIN["arch"]), ("float32_mamba2", "mamba2_370m")):
            base32 = get_config(arch)
            cfg32 = dataclasses.replace(base32, n_layers=TRAIN_MESH["check_layers"],
                                        dtype=torch.float32)
            data32 = dataclasses.replace(data, vocab=cfg32.vocab)
            trainers, runs = {}, {}
            for name, kw in (("meshed", dict(mesh=mesh)), ("plain", dict(device=DEVICE))):
                trainers[name] = Trainer(cfg32, opt, TrainConfig(
                    steps=TRAIN_MESH["check_steps"], checkpoint_every=0, remat="full",
                    attn_impl="chunked", fsdp=name == "meshed",
                    checkpoint_dir=os.path.join(tmp, name)), data32, **kw)
                runs[name] = trainers[name].run()
            a, b = runs["meshed"], runs["plain"]
            rel = max(float((_full(p) - b["params"][k]).abs().max()
                            / b["params"][k].abs().max().clamp_min(1e-30))
                      for k, p in a["params"].items())
            loss_rel = max(abs(x - y) / max(abs(y), 1e-30)
                           for x, y in zip(a["losses"], b["losses"]))
            bitwise = a["losses"] == b["losses"] and all(
                torch.equal(_full(p), b["params"][k]) for k, p in a["params"].items())
            out[key] = {"arch": arch, "layers": cfg32.n_layers,
                        "steps": TRAIN_MESH["check_steps"], "losses_meshed": a["losses"],
                        "losses_plain": b["losses"], "loss_rel_err": loss_rel,
                        "param_rel_err": rel, "bit_for_bit": bitwise, "tolerance": 1e-6}
            if not bitwise:
                out[key]["first_different_op"] = first_different_op(
                    trainers["meshed"], trainers["plain"], SyntheticLM(data32).batch(0))
            require(loss_rel <= 1e-6 and rel <= 1e-6, f"train_mesh: {key} {out[key]}")
            del trainers, runs, a, b
            gc.collect()
            torch.cuda.empty_cache()

        # (c) elastic restore: saved under the fsdp mesh, restored after remesh
        cfg2 = dataclasses.replace(cfg, n_layers=TRAIN_MESH["elastic_layers"])
        ck = os.path.join(tmp, "elastic")
        steps = TRAIN_MESH["elastic_steps"]
        saved = Trainer(cfg2, opt, TrainConfig(steps=steps, checkpoint_every=steps,
                                               checkpoint_dir=ck, fsdp=True, remat="full",
                                               attn_impl="chunked"), data, mesh=mesh).run()
        tr = Trainer(cfg2, opt, TrainConfig(checkpoint_dir=ck, attn_impl="chunked"), data,
                     device=DEVICE)
        tr.remesh(mesh)
        params, opt_state = tr.init_state()
        opt_state, step = tr._restore(params, opt_state)
        p_equal = all(torch.equal(_full(params[k]), _full(p)) for k, p in saved["params"].items())
        m_equal = all(torch.equal(_full(opt_state[part][k]), _full(m)) for part in ("mu", "nu")
                      for k, m in saved["opt_state"][part].items())
        out["elastic"] = {"layers": cfg2.n_layers, "saved_at_step": steps, "restored_step": step,
                          "saved_fsdp": True, "restored_fsdp": False,
                          "checkpoint_bytes": dir_bytes(ck), "params_bit_equal": p_equal,
                          "moments_bit_equal": m_equal}
        require(step == steps and p_equal and m_equal, f"train_mesh: elastic {out['elastic']}")
        del saved, tr, params, opt_state
        launches = read_counts()
        out["kernel_launches"] = launches
        require(launches == {"flash_attention": 0, "mamba2_ssd": 0},
                f"train_mesh: a forward-only kernel was launched: {launches}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    emit("train_mesh", **out)


def _gib(x):
    return round(x / 2**30, 3)


#: per-device flops, wire GiB and temporary GiB of the 16 x 16 cells in the
#: gathered layout, before the model axis split products (every rank gathered
#: each layer's weights and computed whole layers), as PERF.md section 6
#: records them: the dry-run of the commit before the split, on the card's
#: machine (the transformer families' before their split, the ssm, hybrid
#: and audio families' before theirs)
GATHERED_16X16 = {
    "qwen2_7b/train_4k": {"flops": 3.888697749536768e15, "wire_gib": 41.32, "temp_gib": 98.741},
    "qwen2_7b/decode_32k": {"flops": 2.18351271936e11, "wire_gib": 26.423, "temp_gib": 20.125},
    "llama4_scout_17b_a16e/train_4k": {"flops": 1.00442105184256e16, "wire_gib": 587.644,
                                       "temp_gib": 151.92},
    "llama4_scout_17b_a16e/decode_32k": {"flops": 1.96551901184e12, "wire_gib": 233.183,
                                         "temp_gib": 69.0},
    "stablelm_3b/train_4k": {"flops": 1.67555264151552e15, "wire_gib": 15.197,
                             "temp_gib": 98.982},
    "mamba2_370m/train_4k": {"flops": 1.71717087461376e14, "wire_gib": 1.322,
                             "temp_gib": 514.219},
    "mamba2_370m/decode_32k": {"flops": 6.090522624e9, "wire_gib": 0.909, "temp_gib": 0.726},
    "zamba2_2_7b/train_4k": {"flops": 1.790219678384128e15, "wire_gib": 12.564,
                             "temp_gib": 245.71},
    "zamba2_2_7b/decode_32k": {"flops": 7.5304583168e10, "wire_gib": 25.687,
                               "temp_gib": 32.658},
    "whisper_large_v3/train_4k": {"flops": 6.3590781026304e14, "wire_gib": 8.982,
                                  "temp_gib": 363.895},
    "whisper_large_v3/decode_32k": {"flops": 2.57703596032e12, "wire_gib": 38.159,
                                    "temp_gib": 55.703},
}


def shape_flops(cfg, kind, seq_len, global_batch, data=16, model=16):
    """Per-device matrix-product flops of a dry-run cell (``train`` under
    remat ``full``, or ``decode``) on a ``data x model`` mesh, from the
    shapes alone: a device's rows of the batch and, on the model axis, a
    ``model``-th of each product the rules split (the heads where ``n_heads``
    divides the axis and a rank's query heads read their own share of the K
    / V heads or one K / V head, ``ff``, the experts or ``ff_expert``, the
    vocabulary), the rest whole.  The chunked attention pads the keys to
    1,024; the MoE runs ``C`` slots an expert over 256 tokens, every token
    (then a weighted sum over the experts) up to 256.  Under remat ``full``
    each layer's products count 4 times (forward, recomputation, both
    operands' gradients) but the block's last product, whose output nothing
    in backward reads, so that the recomputation stops before it (``w_down``,
    or an ungated shared expert's ``ws_down``): 3 times; the head 4 times."""
    if cfg.family in ("ssm", "hybrid", "audio"):
        return _shape_flops_mamba_audio(cfg, kind, seq_len, global_batch, data, model)
    M, B = model, global_batch // data
    D, Dh, L = cfg.d_model, cfg.dh, cfg.n_layers
    Hq, Hkv = cfg.n_heads, cfg.n_kv_heads

    def part(n):
        return n // M if n % M == 0 else n

    hq, hkv = Hq, Hkv
    if Hq % M == 0 and (Hkv % M == 0 or (Hq // Hkv) % (Hq // M) == 0):
        hq, hkv = Hq // M, max(Hkv // M, 1)
    S = 1 if kind == "decode" else seq_len
    keys = -(-seq_len // 1024) * 1024
    T = B * S
    layer = 2 * T * D * (hq + 2 * hkv) * Dh + 2 * T * hq * Dh * D + 4 * B * hq * S * keys * Dh
    if cfg.moe is None:
        F = part(cfg.d_ff)
        layer += 6 * T * D * F
        last = 2 * T * F * D
    else:
        m, last = cfg.moe, 0
        E = m.n_experts
        local, fe = (E // M, m.d_ff_expert) if E % M == 0 else (E, part(m.d_ff_expert))
        if T <= transformer.DENSE_PATH_MAX_TOKENS:
            # the weighted sum is a batched product but over one expert
            # (einsum then multiplies)
            rows, combine = T, 2 * T * local * D if local > 1 else 0
        else:
            rows, combine = int(np.ceil(T * m.top_k / E * m.capacity_factor)), 0
        layer += 2 * T * D * E + 6 * local * rows * D * fe + combine
        if m.n_shared:
            fs = part(m.d_ff_shared)
            layer += 6 * T * D * fs + (2 * T * D if m.shared_gate else 0)
            last = 0 if m.shared_gate else 2 * T * fs * D
    head = 2 * T * D * part(cfg.vocab)
    if kind == "decode":
        return L * layer + head
    return 4 * L * layer - L * last + 4 * head


def ssd_flops(B, S, H, P, N, chunk):
    """The matrix-product flops of ``mamba2.ssd_chunked``'s forward over
    ``(B, S, H, P, N)`` at ``chunk`` ``Q``, the prompt padded to whole
    chunks: for every chunk row, the scores ``C Bᵀ`` (``Q·N``), the
    intra-chunk output (``H·Q·P``), the chunk states and the inter-chunk
    output (``H·P·N`` each).  Each is one product of two operands, so its
    backward costs twice its forward."""
    rows = B * -(-S // chunk) * chunk
    return 2 * rows * (chunk * N + H * chunk * P + 2 * H * P * N)


def ssd_decode_flops(B, H, P, N, conv, taps=4):
    """The products of one mamba decode step that are not a leaf's: the
    depthwise conv over its window (``taps`` rows of ``conv`` channels) and
    ``mamba2.ssd_decode_step``'s ``y = C h``."""
    return 2 * B * taps * conv + 2 * B * H * P * N


def _shape_flops_mamba_audio(cfg, kind, seq_len, global_batch, data, model):
    """:func:`shape_flops` of the ssm, hybrid and audio families.  A mamba
    layer: ``in_proj``'s ``z`` / ``x`` / ``dt`` columns and ``out_proj`` a
    ``model``-th where the SSM heads divide the axis, ``B`` / ``C`` whole,
    and the SSD's products on the rank's heads (:func:`ssd_flops`;
    decode: :func:`ssd_decode_flops`).  zamba2's shared block, every
    ``attn_period`` layers, and whisper's encoder (1,500 frames, keys padded
    to 2,048), decoder and cross-attention products as a transformer's.
    Training: the ssm family recomputes nothing (3 times each product, the
    SSD forward and backward); zamba2 recomputes each group of mamba layers
    and its shared block (4 times, ``w_down`` 3, the SSD's forward twice);
    whisper recomputes each decoder layer (4 times, cross-attention's
    ``xo`` 3) but not the encoder (3 times; ``frame_proj`` twice: its input
    asks for no gradient); the tied head 4 times."""
    from repro_torch.configs import ShapeCell
    from repro_torch.launch import specs
    from repro_torch.models import mamba2

    M, B = model, global_batch // data
    D, Dh, L = cfg.d_model, cfg.dh, cfg.n_layers
    g = specs.cell_geometry(cfg, ShapeCell("cell", seq_len, global_batch, kind))

    def part(n):
        return n // M if n % M == 0 else n

    def pad(n):
        return -(-n // 1024) * 1024

    S = 1 if kind == "decode" else g["seq"]
    T = B * S
    head = 2 * T * D * part(cfg.vocab)
    hq = hkv = 0
    if cfg.n_heads:
        hq, hkv = (cfg.n_heads // M, cfg.n_kv_heads // M) if cfg.n_heads % M == 0 else (
            cfg.n_heads, cfg.n_kv_heads)

    def attn(rows, q_rows, keys, kv_rows=None):
        """One attention's products: projections, scores and values."""
        kv_rows = rows if kv_rows is None else kv_rows
        return (2 * rows * D * hq * Dh + 2 * kv_rows * D * 2 * hkv * Dh
                + 2 * rows * hq * Dh * D + 4 * q_rows * hq * keys * Dh)

    mlp, last = 6 * T * D * part(cfg.d_ff), 2 * T * part(cfg.d_ff) * D

    if cfg.family == "audio":
        frames = g["n_frames"]
        Te = B * frames
        enc = attn(Te, Te, pad(frames)) + 6 * Te * D * part(cfg.d_ff)
        keys = pad(specs.decode_inputs(cfg, ShapeCell("c", seq_len, global_batch, kind))[1]
                   ["kv"][0].shape[2]) if kind == "decode" else pad(S)
        dec = attn(T, T, keys) + attn(T, T, pad(frames), kv_rows=Te) + mlp
        xo = 2 * T * hq * Dh * D
        if kind == "decode":
            return L * dec + head
        return 2 * 2 * Te * D * D + 3 * L * enc + 4 * L * dec - L * xo + 4 * head

    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    h = part(H)
    proj = 2 * T * D * (2 * h * P + 2 * N + h) + 2 * T * h * P * D
    apps = cfg.n_layers // cfg.attn_period if cfg.family == "hybrid" else 0
    period = cfg.attn_period or L + 1
    if kind == "decode":
        keys = pad(seq_len)
        shared = attn(T, T, keys) + mlp
        conv = ssd_decode_flops(B, h, P, N, h * P + 2 * N, mamba2.D_CONV)
        return L * (proj + conv) + apps * shared + head
    fwd = ssd_flops(B, S, h, P, N, cfg.ssm_chunk)
    both = 3 * fwd
    if cfg.family == "ssm":
        return 3 * L * proj + L * both + 4 * head
    grouped = apps * period
    shared = attn(T, T, pad(S)) + mlp
    return (grouped * (4 * proj + fwd + both) + (L - grouped) * (3 * proj + both)
            + apps * (4 * shared - last) + 4 * head)


def phase_dryrun(ctx):
    """``python -m repro_torch.launch.dryrun`` on meta tensors, in processes
    of their own (started by :func:`start_dryruns`): every stablelm_3b cell on
    the card's one-rank mesh, qwen2_7b and llama4 train_4k / decode_32k and
    stablelm_3b train_4k, and mamba2_370m, zamba2_2_7b and whisper_large_v3
    train_4k / decode_32k on 16 x 16.  Each record's status, flops, bytes,
    per-device memory and collective bytes; a record that failed is printed
    with its error.  Each 16 x 16 cell must run, and its flops must be
    within 1 % of :func:`shape_flops`; ``split_16x16`` prints its per-device
    flops, wire and temporary GiB beside the gathered layout's
    (:data:`GATHERED_16X16`)."""
    summary, split, off = {}, {}, []
    for name in DRYRUN:
        records, waited = dryrun_records(ctx, name)
        for r in records if name.endswith("16x16") else ():
            key = f"{r['arch']}/{r['shape']}"
            if r["status"] != "ok":
                off.append(f"{key}: {r['status']} {r.get('error', '')}")
                continue
            want = shape_flops(get_config(r["arch"]), r["kind"], r["seq_len"], r["global_batch"])
            rel = abs(r["flops"] - want) / want
            split[key] = {"flops": r["flops"], "shape_flops": want, "rel_err": rel,
                          "wire_gib": _gib(r["collectives"]["wire_bytes"]),
                          "temp_gib": _gib(r["memory"]["temp_bytes"]),
                          "collective_counts": r["collectives"]["counts"],
                          "gathered_layout": GATHERED_16X16.get(key)}
            if rel > 0.01:
                off.append(f"{key}: flops {r['flops']:.6e}, shapes give {want:.6e}")
        rows = []
        for r in records:
            row = {k: r[k] for k in ("arch", "shape", "mesh", "kind", "status")}
            if r["status"] == "ok":
                m, c = r["memory"], r["collectives"]
                row.update(flops=r["flops"], bytes_accessed=r["bytes_accessed"],
                           memory_gib={k: _gib(v) for k, v in m.items()},
                           collectives={"total_gib": _gib(c["total_bytes"]),
                                        "wire_gib": _gib(c["wire_bytes"]), "counts": c["counts"]},
                           trace_s=r["lower_s"], placements=r.get("placements"),
                           divisibility=r["divisibility"])
            elif r["status"] == "error":
                row["error"] = r["error"]
            else:
                row["skip_reason"] = r["skip_reason"]
            rows.append(row)
        summary[name] = {"args": DRYRUN[name], "ended_after_s": waited, "records": rows}
        require(all(r["status"] in ("ok", "skipped", "error") for r in records), name)
    require(len(summary["stablelm_1gpu"]["records"]) == 4, "dryrun: stablelm_3b has 4 cells")
    emit("dryrun", card=ctx.get("card"), sweeps=summary, split_16x16=split,
         errors=[f"{r['arch']}/{r['shape']}/{r['mesh']}: {r['error']}" for s in summary.values()
                 for r in s["records"] if r["status"] == "error"])
    require(not off and len(split) == SPLIT_CELLS,
            f"dryrun: 16 x 16 cells off their shapes' flops: {off}")


def phase_select(ctx):
    """A11 on the card, the paper's Fig. 9 contract: the stablelm_3b training
    cell at the train phase's 8 x 512 tokens on the one-rank mesh, variants
    remat {none, dots, full} x microbatches {1, 4}.  Each is dry-run, costed
    against the card's memory (``cost_from_record(..., hbm_bytes=
    total_memory)``) and ranked by ``select``; only the variants predicted to
    fit are launched (no variant ``select`` rejects is run): 1 warm-up step
    and 3 timed steps each on the meshed trainer, with the measured peak of
    device memory.  The phase fails if a variant predicted to fit runs out of
    memory or the chosen one does not run; a mis-ranking is reported, not
    failed."""
    from repro_torch.core.tpu_predictor import cost_from_record, select
    from repro_torch.data import DataConfig
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import TrainConfig, Trainer

    records = []
    for remat in SELECT["remats"]:
        recs, _ = dryrun_records(ctx, f"select_{remat}")
        records.extend(recs)
    require(len(records) == len(SELECT["remats"]) * len(SELECT["microbatches"])
            and all(r["status"] == "ok" for r in records),
            f"select: dry-run records {[(r['remat'], r['microbatches'], r['status'], r.get('error')) for r in records]}")
    hbm = torch.cuda.get_device_properties(0).total_memory
    costs = {(r["remat"], r["microbatches"]): cost_from_record(
        r, name=f"remat_{r['remat']}_mb{r['microbatches']}", hbm_bytes=hbm) for r in records}
    best, ranked = select(list(costs.values()))
    cfg = get_config(TRAIN["arch"])
    steps = SELECT["warmup"] + SELECT["timed"]
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=steps)
    data = DataConfig(vocab=cfg.vocab, seq_len=TRAIN["seq_len"],
                      global_batch=TRAIN["global_batch"], seed=TRAIN["data_seed"])
    mesh = host_mesh(ctx)
    rows = {}
    reset_counts()
    for rec in records:
        key = (rec["remat"], rec["microbatches"])
        v = costs[key]
        m = rec["memory"]
        row = {"variant": v.name, "estimate_ms": v.estimate_s * 1e3, "dominant": v.dominant,
               "terms_ms": {k: t * 1e3 for k, t in v.terms.items()},
               "predicted_peak_gb": _gib(m["argument_bytes"] + m["temp_bytes"] + m["output_bytes"]),
               "predicted_fits": v.fits_hbm, "launched": v.fits_hbm}
        if v.fits_hbm:
            gc.collect()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            try:
                run = Trainer(cfg, opt, TrainConfig(steps=steps, checkpoint_every=0,
                                                    remat=key[0], microbatches=key[1], fsdp=True,
                                                    attn_impl="chunked"), data, mesh=mesh).run()
                torch.cuda.synchronize()
                row.update(step_ms=[t * 1e3 for t in run["step_seconds"]],
                           timed_step_ms=float(np.median(run["step_seconds"][SELECT["warmup"]:]))
                           * 1e3, losses=run["losses"],
                           measured_peak_gb=_gib(torch.cuda.max_memory_allocated() - base))
            except torch.cuda.OutOfMemoryError as e:
                row["oom"] = str(e)[:300]
            finally:
                run = None   # the variant's parameters and moments go before the next one
        rows[v.name] = row
    gc.collect()
    torch.cuda.empty_cache()
    launches = read_counts()
    ran = {k: r for k, r in rows.items() if "timed_step_ms" in r}
    ooms = [k for k, r in rows.items() if "oom" in r]
    measured_best = min(ran, key=lambda k: ran[k]["timed_step_ms"]) if ran else None
    slowest = max(ran, key=lambda k: ran[k]["timed_step_ms"]) if ran else None
    out = {"card": ctx.get("card"), "hbm_bytes": hbm, "cell": {
               "arch": cfg.name, "seq_len": TRAIN["seq_len"], "global_batch": TRAIN["global_batch"],
               "mesh": "1gpu", "fsdp": True, "attn_impl": "chunked"},
           "variants": list(rows.values()), "chosen": best.name,
           "ranked_by_estimate": [v.name for v in ranked], "measured_best": measured_best,
           "chosen_is_measured_best": best.name == measured_best,
           "chosen_is_measured_slowest": best.name == slowest and len(ran) > 1,
           "predicted_to_fit_but_oom": ooms, "kernel_launches": launches}
    emit("select", **out)
    require(not ooms, f"select: variants predicted to fit ran out of memory: {ooms}")
    require(best.name in ran, f"select: the chosen variant {best.name} did not run")
    require(launches == {"flash_attention": 0, "mamba2_ssd": 0},
            f"select: a forward-only kernel was launched: {launches}")


def phase_dryrun_all(ctx):
    """Not in the default run: ``--all --mesh both``, one process an
    architecture, at most as many at once as the host has cores; the wall
    time of the whole sweep and the cells that came out ``error``."""
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip_smoke_sweep_")
    ctx.setdefault("tmp_dirs", []).append(tmp)
    from repro_torch.configs import ARCH_IDS

    t0 = time.perf_counter()
    pending, running, done = list(ARCH_IDS), {}, {}
    width = max(1, os.cpu_count() or 1)
    while pending or running:
        while pending and len(running) < width:
            arch = pending.pop(0)
            out = os.path.join(tmp, f"{arch}.json")
            running[arch] = (subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--mesh",
                 "both", "--out", out], cwd=ROOT, env=_subprocess_env(),
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL), out)
            ctx.setdefault("processes", []).append(running[arch][0])
        for arch, (proc, out) in list(running.items()):
            if proc.poll() is not None:
                done[arch] = (proc.returncode, out)
                del running[arch]
        time.sleep(0.5)
    seconds = time.perf_counter() - t0
    records = []
    for arch, (rc, out) in done.items():
        require(rc == 0 and os.path.exists(out), f"dryrun_all: {arch} exited {rc}")
        with open(out) as f:
            records.extend(json.load(f))
    emit("dryrun_all", card=ctx.get("card"), seconds=seconds, processes=width,
         cells=len(records), ok=sum(r["status"] == "ok" for r in records),
         skipped=sum(r["status"] == "skipped" for r in records),
         errors=[{"arch": r["arch"], "shape": r["shape"], "mesh": r["mesh"], "error": r["error"]}
                 for r in records if r["status"] == "error"],
         trace_s={f"{r['arch']}/{r['shape']}/{r['mesh']}": r["lower_s"] for r in records
                  if r["status"] == "ok"})


DENSE_WHY = ("bf16 through every layer: the kernel and attention_chunked round each layer's "
             "attention output on their own; 1e-1 as in serve, or twice the spread of attention "
             "'xla' against 'chunked' (the same function, other roundings) where that is larger")


def phase_serve_gemma3(ctx):
    """gemma3_1b at full width and depth: heads of 256, a 512-token window on
    its local layers (the prompts of 64-512 tokens and 32 new ones cross it)."""
    serve_path(ctx, "serve_gemma3", "gemma3_1b",
               attention_launches(get_config("gemma3_1b").n_layers),
               {"attn_impl": "chunked"}, 1e-1, DENSE_WHY, ATTN_SPREAD)


def phase_serve_qwen2_7b(ctx):
    """qwen2_7b at full width and depth (GQA 7, QKV bias)."""
    serve_path(ctx, "serve_qwen2_7b", "qwen2_7b",
               attention_launches(get_config("qwen2_7b").n_layers),
               {"attn_impl": "chunked"}, 1e-1, DENSE_WHY, ATTN_SPREAD)


def phase_serve_granite(ctx):
    """granite_8b at full width and depth (GQA 4)."""
    serve_path(ctx, "serve_granite", "granite_8b",
               attention_launches(get_config("granite_8b").n_layers),
               {"attn_impl": "chunked"}, 1e-1, DENSE_WHY, ATTN_SPREAD)


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


def graph_ms(fn, iters=20, replays=3, strict=True):
    """Device time of one call of ``fn``: ``iters`` calls captured in one CUDA
    graph, replayed ``replays`` times between two events.  Unlike ``time_ms``
    this leaves out the host's time to issue each call, which at decode shapes
    is longer than the kernel.  ``strict`` captures in the global mode, where a
    call that synchronised or read a value back would fail the capture: so a
    time of one of the port's wrappers also shows that it needs neither.  The
    library's calls are captured in the relaxed mode (their safety is not
    what is checked here)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    side.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side,
                          capture_error_mode="global" if strict else "relaxed"):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (iters * replays)


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


def bound_visible(q, k, v, qpos, kpos):
    """The same bound counting only the K / V rows that some query row sees and
    the (query, key) pairs that are visible: the work these positions need."""
    B, Sq, Hq, Dh = q.shape
    Hkv = k.shape[2]
    mask = ref.attention_mask(qpos[:, :, None], kpos[:, None, :])
    pairs = int(mask.sum())
    kv_rows = int(mask.any(1).sum())
    nbytes = 2 * q.numel() * q.element_size() + 2 * kv_rows * Hkv * Dh * k.element_size()
    nbytes += 4 * (B * Sq + k.shape[1] * B)
    flops = 4 * Hq * Dh * pairs
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_BF16_FLOPS * 1e3
    return {"visible_pairs": pairs, "visible_kv_rows": kv_rows, "bytes_visible": nbytes,
            "flops_visible": flops, "bound_visible_ms": max(t_bytes, t_ops),
            "bound_visible_by": "bytes" if t_bytes >= t_ops else "operations"}


def sdpa(qt, kt, vt, attn_mask):
    """The library's attention on the kernel's own inputs, in the library's
    ``(B, H, S, Dh)`` layout: grouped-query heads by ``enable_gqa``, not by a
    copy of K / V."""
    return torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=attn_mask, enable_gqa=qt.shape[1] != kt.shape[1])


def library_times(qt, kt, vt, mask, math=True):
    """``scaled_dot_product_attention`` under each backend that admits a boolean
    mask, timed as the kernel is (eager ``time_ms`` and device ``graph_ms``); a
    backend that refuses the call is reported as refused.  ``library_ms`` is
    the fastest eager time, ``library_device_ms`` the fastest device time.
    ``math`` False leaves out the backend that builds the whole score matrix."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    eager, device, refused = {}, {}, {}
    backends = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                SDPBackend.CUDNN_ATTENTION] + ([SDPBackend.MATH] if math else [])
    for backend in backends:
        try:
            with sdpa_kernel([backend]):
                sdpa(qt, kt, vt, attn_mask=mask)
                torch.cuda.synchronize()
                eager[backend.name] = time_ms(lambda: sdpa(qt, kt, vt, attn_mask=mask))
                device[backend.name] = graph_ms(lambda: sdpa(qt, kt, vt, attn_mask=mask),
                                                strict=False)
        except RuntimeError as exc:
            refused[backend.name] = str(exc).splitlines()[0][:120]
    require(eager, "no SDPA backend took the boolean mask")
    best, best_dev = min(eager, key=eager.get), min(device, key=device.get)
    return {"library_ms": eager[best], "library_backend": best,
            "library_device_ms": device[best_dev], "library_device_backend": best_dev,
            "library_backends_ms": eager, "library_backends_device_ms": device,
            "library_backends_refused": refused}


#: the attention kernel's timed shapes (bf16) and where their queries sit:
#: stablelm_3b's heads with queries that see every key of a full cache ("full":
#: the newest token; "end": the last 512), as the serving path sends them
#: ("serve": slots of 64-544 tokens in a 1,024-slot cache; "prompt": a prompt
#: from position 0), and a 4,096-token causal prompt, whose grid (2,048 mma
#: blocks) fills the card many times over where the serving shapes' 256 blocks
#: are one wave; then the heads of 128 of qwen2_moe (16/16) and qwen2_vl (12/2)
#: at their serving shapes, and whisper's three attentions (20 heads of 64)
ATTN_TIMED = {
    "decode": ((8, 1, 1024, 32, 32, 80), "full"),
    "prefill": ((1, 512, 1024, 32, 32, 80), "end"),
    "serve_decode": ((8, 1, 1024, 32, 32, 80), "serve"),
    "serve_prefill": ((1, 512, 1024, 32, 32, 80), "prompt"),
    "long_prefill": ((1, 4096, 4096, 32, 32, 80), "prompt"),
    "qwen2_moe_decode": ((8, 1, 1024, 16, 16, 128), "serve"),
    "qwen2_moe_prefill": ((1, 512, 1024, 16, 16, 128), "prompt"),
    "qwen2_vl_decode": ((8, 1, 1024, 12, 2, 128), "serve"),
    "whisper_encoder": ((8, 1500, 1500, 20, 20, 64), "all"),
    "whisper_decode_self": ((8, 1, 448, 20, 20, 64), "whisper"),
    "whisper_decode_cross": ((8, 1, 1500, 20, 20, 64), "all"),
}
QUERY_POSITIONS = {"full": "the last of a full cache", "end": "the last of a full cache",
                   "serve": "what Server.serve sends", "prompt": "a prompt from position 0",
                   "all": "position Skv: every query sees every key (whisper's encoder and "
                          "cross-attention)",
                   "whisper": "position 16 of a 448-slot cache (the middle of serve_whisper's "
                              "32 decode steps)"}


def phase_kernels(ctx):
    rows = {}
    for name, (shape, where) in ATTN_TIMED.items():
        q, k, v, qpos, kpos = make_case(*shape, torch.bfloat16)
        if where == "full":     # the query is the newest token of a full cache
            qpos = torch.full((shape[0], 1), shape[2] - 1, dtype=torch.int32, device=q.device)
        elif where == "serve":  # slots of 64-544 tokens in a 1,024-slot cache
            qpos = torch.as_tensor(serve_lengths(shape[0])[:, None] - 1, dtype=torch.int32,
                                   device=q.device)
        elif where == "prompt":  # a prompt from position 0
            qpos = torch.arange(shape[1], dtype=torch.int32, device=q.device)[None]
        elif where == "all":     # every query sees every key
            qpos = torch.full((shape[0], shape[1]), shape[2], dtype=torch.int32, device=q.device)
        elif where == "whisper":  # a decode step in the middle of serve_whisper's 32
            qpos = torch.full((shape[0], 1), 16, dtype=torch.int32, device=q.device)
        plan = fa.choose_tile(shape[1], shape[2], shape[5], dtype=q.dtype,
                              groups=shape[3] // shape[4], batch_kv_heads=shape[0] * shape[4])
        got = ops.flash_attention(q, k, v, qpos, kpos)
        plain = fa.flash_attention_plain(q, k, v, qpos, kpos)
        err, ok = compare(got, plain, TOL[torch.bfloat16])
        require(ok, f"kernel disagrees with its plain version at the {name} shape")
        mask = ref.attention_mask(qpos[:, None, :, None], kpos[:, None, None, :])
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib = sdpa(qt, kt, vt, attn_mask=mask)
        err_lib, _ = compare(got, lib.transpose(1, 2), TOL[torch.bfloat16])
        # the same kernel on copies that are not 16-byte aligned: its element-wise loads
        qm, km, vm = misaligned(q), misaligned(k), misaligned(v)
        err_m, ok = compare(ops.flash_attention(qm, km, vm, qpos, kpos), got, 0.0)
        require(ok, f"element-wise and 16-byte loads disagree at the {name} shape ({err_m})")

        def run_kernel():
            return ops.flash_attention(q, k, v, qpos, kpos)

        def run_plain():
            return fa.flash_attention_plain(q, k, v, qpos, kpos)

        def run_scalar():
            return ops.flash_attention(qm, km, vm, qpos, kpos)

        # in turns, eager calls between CUDA events (the host's time to issue
        # each call included; the kernel's earlier times were taken so): plain,
        # scalar, kernel, kernel, scalar, plain; then device times from CUDA graphs
        t_plain = [time_ms(run_plain, 1, 5)]
        t_scalar = [time_ms(run_scalar)]
        t_kernel = [time_ms(run_kernel) for _ in range(2)]
        t_scalar.append(time_ms(run_scalar))
        t_plain.append(time_ms(run_plain, 1, 5))
        d_kernel = [graph_ms(run_kernel) for _ in range(2)]
        d_scalar = graph_ms(run_scalar)
        rows[name] = {"shape": dict(zip(("B", "Sq", "Skv", "Hq", "Hkv", "Dh"), shape)),
                      "dtype": "bfloat16", "path": plan.path, "plan": dataclasses.asdict(plan),
                      "query_positions": QUERY_POSITIONS[where],
                      "max_abs_err": err, "err_vs_library": err_lib,
                      "kernel_ms": min(t_kernel), "kernel_ms_runs": t_kernel,
                      "kernel_ms_scalar_loads": min(t_scalar),
                      "device_ms": min(d_kernel), "device_ms_runs": d_kernel,
                      "device_ms_scalar_loads": d_scalar,
                      "timing": "*_ms: CUDA events around 20 eager calls, the host's issue "
                                "time included; *device_ms: device time of one call, from "
                                "CUDA graphs of 20 calls",
                      "plain_ms": min(t_plain),
                      **library_times(qt, kt, vt, mask, math=name != "long_prefill"),
                      **bound(q, k, v, qpos, kpos), **bound_visible(q, k, v, qpos, kpos)}
        r = rows[name]
        r["roofline_share"] = r["bound_ms"] / r["kernel_ms"]
        r["device_roofline_share"] = r["bound_ms"] / r["device_ms"]
        r["device_visible_roofline_share"] = r["bound_visible_ms"] / r["device_ms"]
    dec = rows["decode"]   # 31 of 32 forward passes of a request are decode steps
    attn = {"name": "flash_attention", "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": KERNEL_REPLACES, **path_launches(ctx, "flash_attention"),
            "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
            "ms": dec["kernel_ms"], "plain_ms": dec["plain_ms"], "bound_ms": dec["bound_ms"],
            "bound_by": dec["bound_by"], "library_ms": dec["library_ms"],
            "library_backend": dec["library_backend"], "device_ms": dec["device_ms"],
            "library_device_ms": dec["library_device_ms"], "path": dec["path"],
            "top_level_shape": "decode", "card": ctx.get("card"), "shapes": rows}
    ctx["kernels_line"] = {"kernels": [attn, ssd_entry(ctx)]}
    if ctx.get("launches"):
        for entry in ctx["kernels_line"]["kernels"]:
            require(entry["launches"] > 0, f"the main paths never launched {entry['name']}")
    print(json.dumps(ctx["kernels_line"]), flush=True)


def path_launches(ctx, name):
    """A kernel's launches on the serving paths that ran: the sum and each path's."""
    by_path = {phase: counts[name] for phase, counts in ctx.get("launches", {}).items()}
    out = {"launches": sum(by_path.values()), "launches_by_path": by_path}
    if name == "flash_attention":
        out["launches_by_kernel_path"] = ctx.get("attention_paths", {})
    if name == "mamba2_ssd":
        out["launches_by_kernel_path"] = ctx.get("ssd_paths", {})
    return out


def ssd_bound(x, dt, a, bm, cm, y, h_last):
    """Least time the card could take for the scan: every input read once and
    every output written once at the memory rate, or the operations of the
    64-row dual form (C Bᵀ once per chunk, lower triangles only, shared by the
    heads; per head W x, C hᵀ and Bᵀ u) at the bf16 tensor-core rate."""
    B, S, H, P = x.shape
    N = bm.shape[-1]
    nbytes = sum(t.numel() * t.element_size() for t in (x, dt, a, bm, cm, y, h_last))
    flops = 0
    for c0 in range(0, S, ssd.CHUNK):
        q = min(ssd.CHUNK, S - c0)
        tri = q * (q + 1) // 2
        flops += B * (2 * tri * N + H * (2 * tri * P + 4 * q * N * P))
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_BF16_FLOPS * 1e3
    return {"bytes": nbytes, "flops": flops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def ssd_entry(ctx):
    """The SSD kernel at the prefill of a 512-token prompt of each model, in the
    model's layout (bf16 x, B, C cut from one tensor; fp32 dt; fp32 y): the
    mma path, timed in turns with its plain version and with every other plan
    (p_block), eager and from CUDA graphs."""
    rows = {}
    for model, (H, P, N) in SSD_MODELS.items():
        args = make_ssd(1, 512, H, P, N, torch.bfloat16, model_layout=True, decays="model")
        plan = ssd.choose_plan(1, H, P, N, torch.bfloat16)
        y, h = ops.mamba2_ssd(*args, out_dtype=torch.float32)
        y_plain, h_plain = ssd.ssd_plain(*args, out_dtype=torch.float32)
        err_y, ok_y = compare(y, y_plain, SSD_TOL[torch.float32])
        err_h, ok_h = compare(h, h_plain, SSD_TOL[torch.float32])
        require(ok_y and ok_h, f"SSD kernel disagrees with its plain version at {model}'s shape")

        def run(ps=None):
            return lambda: ops.mamba2_ssd(*args, p_block=ps, out_dtype=torch.float32)

        plain = lambda: ssd.ssd_plain(*args, out_dtype=torch.float32)   # noqa: E731
        # in turns: plain, kernel, other plans, kernel, plain (eager, as the
        # earlier times were taken); then device times from CUDA graphs
        others = [ps for ps in ssd.P_BLOCKS if P % ps == 0 and ps != plan.p_block]
        t_plain = [time_ms(plain, 1, 5)]
        t_kernel = [time_ms(run())]
        t_other = {ps: time_ms(run(ps)) for ps in others}
        t_kernel.append(time_ms(run()))
        t_plain.append(time_ms(plain, 1, 5))
        d_kernel = [graph_ms(run()) for _ in range(2)]
        d_other = {ps: graph_ms(run(ps)) for ps in others}
        rows[model] = {"shape": {"B": 1, "S": 512, "H": H, "P": P, "N": N},
                       "dtype": "bfloat16 x/B/C, float32 dt and y", "path": plan.path,
                       "plan": dataclasses.asdict(plan), "p_block": plan.p_block,
                       "blocks": plan.blocks, "max_abs_err": max(err_y, err_h),
                       "kernel_ms": min(t_kernel), "kernel_ms_runs": t_kernel,
                       "device_ms": min(d_kernel), "device_ms_runs": d_kernel,
                       "kernel_ms_other_p_blocks": t_other,
                       "device_ms_other_p_blocks": d_other,
                       "timing": "*_ms: CUDA events around 20 eager calls, the host's issue "
                                 "time included; device_ms*: device time of one call, from "
                                 "CUDA graphs of 20 calls",
                       "plain_ms": min(t_plain), "library_ms": None,
                       **ssd_bound(*args, y, h)}
        r = rows[model]
        r["roofline_share"] = r["bound_ms"] / r["kernel_ms"]
        r["device_roofline_share"] = r["bound_ms"] / r["device_ms"]
    top = rows["mamba2_370m"]
    return {"name": "mamba2_ssd", "route": "cuda", "source": SSD_SOURCE,
            "replaces": SSD_REPLACES, **path_launches(ctx, "mamba2_ssd"),
            "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
            "ms": top["kernel_ms"], "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
            "bound_by": top["bound_by"], "library_ms": None, "device_ms": top["device_ms"],
            "path": top["path"], "library_note": "no single PyTorch call computes the SSD scan",
            "top_level_shape": "mamba2_370m", "card": ctx.get("card"), "shapes": rows}


def phase_serve_throughput(ctx):
    snapshots = ctx.get("snapshots")
    require(snapshots, "serve_throughput needs a serving phase")
    for name, snap in snapshots.items():
        emit("serve_throughput", model=name, card=ctx.get("card"),
             tokens_per_s=snap["tokens_per_s"],
             completions=snap["completions"], tokens=snap["tokens"],
             latency_ms_p50=snap["latency_ms"]["p50"], latency_ms_p99=snap["latency_ms"]["p99"],
             latency_ms_mean=snap["latency_ms"]["mean"], batch_slots=SERVE["batch_slots"],
             max_len=SERVE["max_len"], max_new_tokens=SERVE["max_new_tokens"])


def _device_profile(fn, repeats):
    """``fn`` run ``repeats`` times: host wall ms a run (without the profiler),
    then the device time by kernel from ``torch.profiler`` (device side only)."""
    from torch.profiler import ProfilerActivity, profile

    def run():
        for _ in range(repeats):
            fn()
        torch.cuda.synchronize()

    t0 = time.perf_counter()
    run()
    wall_ms = (time.perf_counter() - t0) * 1e3 / repeats
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    rows = sorted(((dev_us(e), e.key, e.count) for e in prof.key_averages() if dev_us(e) > 0),
                  reverse=True)
    device_ms = sum(r[0] for r in rows) / 1e3 / repeats
    require(device_ms > 0, "the profiler saw no device time")
    # flash_attention_{,mma_,split_}kernel and mamba2_ssd_kernel
    ours = {name: sum(us for us, k, _ in rows if name in k and "_kernel" in k) / 1e3 / repeats
            for name in WRAPPERS}
    return {"wall_ms": round(wall_ms, 3), "device_ms": round(device_ms, 3),
            "device_busy_share": round(device_ms / wall_ms, 4),
            "device_kernels": sum(r[2] for r in rows) / repeats,
            "our_kernels_ms": {k: round(v, 4) for k, v in ours.items()},
            "top": [{"kernel": k[:80], "ms": round(us / 1e3 / repeats, 4), "calls": c / repeats}
                    for us, k, c in rows[:10]]}


def profile_server(ctx, server):
    """Device time by kernel from ``torch.profiler`` for one served model:
    over decode steps of the model at 8 slots (cache filled by a 256-token
    prefill), and over the prefill of one 512-token prompt; the busy share is
    device time over host wall time.  Run by each serving phase while its
    model is on the card, when the ``profile`` phase is asked for."""
    model, cfg = server.model, server.model.cfg
    rng = np.random.default_rng(2)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, size=(8, 256))).to(model.device)
    _, state = model.prefill({"tokens": tokens}, SERVE["max_len"])
    step = tokens[:, :1]

    def decode():
        nonlocal state
        h, state = model.decode_step(step, state)
        model.logits(h).argmax(-1).cpu()

    for _ in range(3):
        decode()
    torch.cuda.synchronize()
    dec = _device_profile(decode, 5)
    prompt = tokens[:1].repeat(1, 2)                       # one prompt of 512 tokens

    def prefill():
        h, _ = model.prefill({"tokens": prompt}, SERVE["max_len"])
        model.logits(h[:, -1:]).argmax(-1).cpu()

    prefill()
    torch.cuda.synchronize()
    pre = _device_profile(prefill, 3)
    ctx.setdefault("profiled", []).append(cfg.name)
    emit("profile", model=cfg.name, layers=cfg.n_layers, card=ctx.get("card"), batch=8,
         decode_steps=5, wall_ms_per_step=dec["wall_ms"], device_ms_per_step=dec["device_ms"],
         device_busy_share=dec["device_busy_share"],
         device_kernels_per_step=dec["device_kernels"], top=dec["top"],
         decode=dec, prefill_512={"prompts": 3, **pre})


def profile_whisper(ctx, model, frames):
    """``profile_server`` for whisper: decode steps of the 8 slots after the
    prefill of their frames, and the prefill (the encoder over 8 x 1,500
    frames) itself."""
    cfg = model.cfg
    batch = {"tokens": torch.zeros((frames.shape[0], 1), dtype=torch.int64, device=DEVICE),
             "frame_embeds": frames}
    _, state = model.prefill(batch, WHISPER["max_len"])
    step = torch.full((frames.shape[0], 1), WHISPER["start"], dtype=torch.int64, device=DEVICE)

    def decode():
        nonlocal state
        h, state = model.decode_step(step, state)
        model.logits(h).argmax(-1).cpu()

    for _ in range(3):
        decode()
    torch.cuda.synchronize()
    dec = _device_profile(decode, 5)

    def prefill():
        enc, _ = model.prefill(batch, WHISPER["max_len"])
        enc.sum().item()

    prefill()
    torch.cuda.synchronize()
    pre = _device_profile(prefill, 3)
    ctx.setdefault("profiled", []).append(cfg.name)
    emit("profile", model=cfg.name, layers=[cfg.n_layers, cfg.n_layers], card=ctx.get("card"),
         batch=frames.shape[0], decode_steps=5, wall_ms_per_step=dec["wall_ms"],
         device_ms_per_step=dec["device_ms"], device_busy_share=dec["device_busy_share"],
         device_kernels_per_step=dec["device_kernels"], top=dec["top"], decode=dec,
         prefill_frames={"frames": WHISPER["frames"], "repeats": 3, **pre})


def phase_profile(ctx):
    """The serving phases profiled their models while each was on the card
    (one full-width model at a time): every served model must have been."""
    served = sorted(ctx.get("served", []))
    require(served, "profile needs a serving phase")
    require(sorted(ctx.get("profiled", [])) == served,
            f"profiled {ctx.get('profiled')}, served {served}")


def stop_everything(ctx) -> None:
    """Every process a phase started is stopped, the process group ended and
    the temporary directories removed, however the run ends."""
    import shutil

    import torch.distributed as dist

    for proc in ctx.get("processes", []):
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if "dryruns" in ctx:
        for job in ctx["dryruns"]["jobs"].values():
            job["log"].close()
        shutil.rmtree(ctx["dryruns"]["dir"], ignore_errors=True)
    if dist.is_initialized():
        dist.destroy_process_group()
    for tmp in ctx.get("tmp_dirs", []):
        shutil.rmtree(tmp, ignore_errors=True)


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
    t_run = time.perf_counter()
    ctx = {"profile": "profile" in wanted, "wanted": wanted}
    phase_seconds = {}
    try:
        for phase in PHASES + EXTRA_PHASES:
            if phase in wanted:
                t0 = time.perf_counter()
                globals()[f"phase_{phase}"](ctx)
                phase_seconds[phase] = round(time.perf_counter() - t0, 3)
    finally:
        stop_everything(ctx)
    emit("run", seconds=round(time.perf_counter() - t_run, 3), phases=wanted,
         phase_seconds=phase_seconds,
         peak_memory_gb=round(torch.cuda.max_memory_allocated() / 2**30, 3))
    if "card" in ctx:
        print(ctx["card"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
