"""Loader for the natively compiled issue loop (``_sim_engine.c``).

The simulator's hot loop is plain scalar arithmetic over a few small
arrays — exactly the shape CPython is slowest at and a C compiler is best
at.  This module compiles ``_sim_engine.c`` once per machine with the
toolchain's C compiler (no third-party dependency; the image bakes the
compiler in), caches the shared object keyed by the source hash, and
exposes the entry point with the same signature as
:func:`repro_torch.core.simulator._issue_loop`.

Everything is optional: if the compiler is missing, the build fails, or
``REGDEM_SIM_NATIVE=0`` is set, :func:`engine` returns ``None`` and the
simulator silently runs its pure-Python loop — which is state-for-state
identical (the conformance test drives both engines over the benchmark
suite, profiled and checkpointed runs included).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import warnings
from typing import List, Optional

import numpy as np

from repro_torch import obs
from repro_torch.obs.stallprof import R_BANK, R_BAR, R_MEM, R_STALL, R_UNIT

#: reason-code order pinned by ``_sim_engine.c`` (REASON_* enum)
REASON_LIST = [R_STALL, R_BANK, R_MEM, R_BAR, R_UNIT]
REASON_INDEX = {r: i for i, r in enumerate(REASON_LIST)}
N_REASONS = len(REASON_LIST)

_SOURCE = os.path.join(os.path.dirname(__file__), "_sim_engine.c")

_fn = None
_failed = False
_warned = False


def _warn_fallback(exc: Exception) -> None:
    """The compile failed: say so **once** and count it, instead of
    silently serving ~20x lower simulator throughput.  In production the
    ``simulator.native_unavailable`` counter is the diagnosable signal
    (warnings scroll away; ``metrics_snapshot()`` does not)."""
    global _warned
    if obs.enabled():
        obs.metrics().counter("simulator.native_unavailable").inc()
    if not _warned:
        _warned = True
        warnings.warn(
            f"native simulator engine unavailable ({exc!r}); falling back "
            "to the pure-Python issue loop (~20x slower; results are "
            "identical). Set CC to a working C compiler, or set "
            "REGDEM_SIM_NATIVE=0 to silence this warning.",
            RuntimeWarning,
            stacklevel=4,
        )


def _cache_dir() -> str:
    override = os.environ.get("REGDEM_NATIVE_CACHE")
    if override:
        return override
    # repo-local build cache (src/repro_torch/core -> repo root), beside the
    # port's CUDA kernels; fall back to the system temp dir when the tree is
    # read-only
    root = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..", ".."))
    cand = os.path.join(root, "build", "repro_torch")
    try:
        os.makedirs(cand, exist_ok=True)
        return cand
    except OSError:
        return tempfile.gettempdir()


def _compile():
    with open(_SOURCE, "rb") as fh:
        source = fh.read()
    digest = hashlib.sha256(source).hexdigest()[:16]
    so_path = os.path.join(_cache_dir(), f"sim_engine_{digest}.so")
    if not os.path.exists(so_path):
        cc = os.environ.get("CC", "cc")
        tmp = f"{so_path}.tmp.{os.getpid()}"
        subprocess.run(
            [cc, "-O2", "-shared", "-fPIC", "-o", tmp, _SOURCE, "-lm"],
            check=True,
            capture_output=True,
        )
        os.replace(tmp, so_path)  # atomic: concurrent builders agree
    lib = ctypes.CDLL(so_path)
    fn = lib.regdem_issue_loop
    fn.restype = ctypes.c_int64
    fn.argtypes = [ctypes.c_void_p] * 27
    return fn


def available() -> bool:
    """True when the compiled engine is (or can be made) loadable."""
    return engine() is not None


def engine():
    """The native issue-loop entry point, or ``None`` (Python fallback)."""
    global _fn, _failed
    if os.environ.get("REGDEM_SIM_NATIVE", "1").lower() in ("0", "off", "false"):
        return None
    if _failed:
        return None
    if _fn is None:
        try:
            _fn = _compile()
        except Exception as exc:
            _failed = True
            _warn_fallback(exc)
            return None
    return _run


def _waits_flat(ct):
    flat = getattr(ct, "_waits_flat", None)
    if flat is None:
        n_records = len(ct.klass)
        off = np.zeros(n_records + 1, np.int64)
        data: List[int] = []
        for j, ws in enumerate(ct.waits):
            data.extend(ws)
            off[j + 1] = len(data)
        flat = (off, np.asarray(data, dtype=np.int64))
        ct._waits_flat = flat
    return flat


def _run(
    ct,
    n_warps: int,
    max_cycles: int,
    intervals: Optional[List[float]] = None,
    issue_width: int = 4,
    num_barriers: int = 6,
    blame=None,
    resume=None,
    capture=None,
):
    """Marshal one :func:`_issue_loop` call into the compiled engine."""
    from . import simulator as _sim

    n_trace = len(ct.code)
    if n_trace == 0:
        return 0.0, 0
    if intervals is None:
        intervals = _sim._KLASS_INTERVAL
    n_records = len(ct.klass)
    nb = num_barriers
    nc = len(intervals)
    profile = blame is not None
    wait_off, wait_data = _waits_flat(ct)

    pc = np.zeros(n_warps, np.int64)
    next_time = np.zeros(n_warps, np.float64)
    bars = np.zeros(n_warps * nb, np.float64)
    unit_free = np.zeros(nc, np.float64)
    intervals_a = np.asarray(intervals, np.float64)
    rr = 0
    cycle0 = 0.0
    idle0 = 0
    frontier0 = 0
    blame_a = warp_blame = bar_setter = None
    if profile:
        blame_a = np.zeros(n_records * N_REASONS, np.int64)
        warp_blame = np.zeros(n_warps * 2, np.int64)
        warp_blame[0::2] = int(ct.code[0])  # (first record, R_STALL)
        bar_setter = np.full(n_warps * nb, -1, np.int64)
    if resume is not None:
        pc[:] = resume.pc
        next_time[:] = resume.next_time
        bars[:] = np.asarray(resume.bars, np.float64).ravel()
        unit_free[:] = resume.unit_free
        rr = resume.rr
        cycle0 = resume.cycle
        idle0 = resume.idle_cycles
        frontier0 = resume.frontier
        if profile:
            for (rec, reason), c in resume.blame.items():
                blame_a[rec * N_REASONS + REASON_INDEX[reason]] += c
            for w, (rec, reason) in enumerate(resume.warp_blame):
                warp_blame[2 * w] = rec
                warp_blame[2 * w + 1] = REASON_INDEX[reason]
            bar_setter[:] = np.asarray(resume.bar_setter, np.int64).ravel()

    # capture milestones: same rule the Python loop applies
    thresholds: List[int] = []
    if capture is not None and n_trace >= _sim._CKPT_MIN_TRACE:
        marks = {n_trace // d for d in _sim._CKPT_FRACTIONS}
        marks.add((3 * n_trace) // 4)
        thresholds = sorted(m for m in marks if frontier0 < m < n_trace)
    n_thr = len(thresholds)
    slot_i = 3 + 3 * n_warps + n_warps * nb
    slot_d = 1 + n_warps + n_warps * nb + nc
    thr_a = np.asarray(thresholds, np.int64) if n_thr else None
    cap_i = np.zeros(n_thr * slot_i, np.int64) if n_thr else None
    cap_d = np.zeros(n_thr * slot_d, np.float64) if n_thr else None
    cap_blame = (
        np.zeros(n_thr * n_records * N_REASONS, np.int64)
        if (n_thr and profile)
        else None
    )

    params_i = np.asarray(
        [
            n_trace,
            n_records,
            n_warps,
            issue_width,
            nb,
            nc,
            1 if profile else 0,
            n_thr,
            rr,
            idle0,
            frontier0,
        ],
        np.int64,
    )
    params_d = np.asarray([float(max_cycles), cycle0], np.float64)
    out_i = np.zeros(4, np.int64)
    out_d = np.zeros(1, np.float64)

    def ptr(a):
        return a.ctypes.data if a is not None else 0

    _fn(
        ptr(params_i),
        ptr(params_d),
        ptr(ct.code),
        ptr(ct.klass),
        ptr(ct.cost),
        ptr(ct.write_bar),
        ptr(ct.read_bar),
        ptr(ct.write_lat),
        ptr(ct.read_lat),
        ptr(ct.conflicts),
        ptr(ct.is_mem),
        ptr(wait_off),
        ptr(wait_data),
        ptr(intervals_a),
        ptr(pc),
        ptr(next_time),
        ptr(bars),
        ptr(unit_free),
        ptr(blame_a),
        ptr(warp_blame),
        ptr(bar_setter),
        ptr(thr_a),
        ptr(cap_i),
        ptr(cap_d),
        ptr(cap_blame),
        ptr(out_d),
        ptr(out_i),
    )

    cycle = float(out_d[0])
    idle_cycles = int(out_i[0])
    if profile:
        for idx in np.nonzero(blame_a)[0].tolist():
            blame[(idx // N_REASONS, REASON_LIST[idx % N_REASONS])] = int(
                blame_a[idx]
            )
    n_cap = int(out_i[3])
    if capture is not None and n_cap:
        for s in range(n_cap):
            ci = cap_i[s * slot_i : (s + 1) * slot_i]
            cd = cap_d[s * slot_d : (s + 1) * slot_d]
            cp_blame = cp_wblame = cp_bset = None
            if profile:
                bl = cap_blame[
                    s * n_records * N_REASONS : (s + 1) * n_records * N_REASONS
                ]
                cp_blame = {
                    (idx // N_REASONS, REASON_LIST[idx % N_REASONS]): int(bl[idx])
                    for idx in np.nonzero(bl)[0].tolist()
                }
                wb = ci[3 + n_warps : 3 + 3 * n_warps]
                cp_wblame = tuple(
                    (int(wb[2 * w]), REASON_LIST[int(wb[2 * w + 1])])
                    for w in range(n_warps)
                )
                bs = ci[3 + 3 * n_warps :]
                cp_bset = tuple(
                    tuple(bs[w * nb : (w + 1) * nb].tolist())
                    for w in range(n_warps)
                )
            capture.append(
                _sim.SimCheckpoint(
                    frontier=int(ci[0]),
                    cycle=float(cd[0]),
                    idle_cycles=int(ci[1]),
                    rr=int(ci[2]),
                    pc=tuple(ci[3 : 3 + n_warps].tolist()),
                    next_time=tuple(cd[1 : 1 + n_warps].tolist()),
                    bars=tuple(
                        tuple(
                            cd[1 + n_warps + w * nb : 1 + n_warps + (w + 1) * nb]
                            .tolist()
                        )
                        for w in range(n_warps)
                    ),
                    unit_free=tuple(cd[1 + n_warps + n_warps * nb :].tolist()),
                    profiled=profile,
                    blame=cp_blame,
                    warp_blame=cp_wblame,
                    bar_setter=cp_bset,
                )
            )
    return cycle, idle_cycles
