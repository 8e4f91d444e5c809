"""Cycle-approximate multi-warp timing simulator for the abstract ISA.

The paper evaluates variants with nvprof on a GTX Titan X.  Without the GPU,
this simulator is the measurement instrument: it models the Maxwell
microarchitecture features that RegDem's trade-off lives on:

* **occupancy-driven latency hiding** — ``resident_warps`` warps round-robin
  on an SM with an issue width of 4 (four warp schedulers); a warp blocked on
  a scoreboard barrier or stall count lets others issue;
* **scoreboard barriers** — write barriers signal at producer latency
  (global 200cy / shared 24cy / FP64 48cy / SFU 20cy), read barriers at
  operand-read time; wait masks block issue;
* **functional-unit contention** — per-class issue intervals derived from
  unit counts (FP32 128 lanes -> 4 warps/cycle, FP64 4 lanes -> 1 warp per
  8 cycles, LSU/SFU 32 lanes -> 1 warp/cycle).  This is what makes ``md``
  (FP64-bound) immune to occupancy gains, exactly as in §5.5;
* **register bank conflicts** — serialized operand reads extend issue time;
* **stall counts** — fixed-latency dependencies honoured as scheduled.

The simulator executes the *dynamic* instruction stream (loops expanded via
the ``trip_count`` metadata), one SM's resident warps at a time, and scales
to the full launch by wave count.  Its absolute cycle counts are
approximations; variant *ratios* (speedups) are the quantity of interest,
mirroring how the paper reports Fig. 6.

Engine architecture (two stages)
--------------------------------

:func:`simulate` runs a **trace compiler** followed by an **event-driven
issue loop**:

1. :func:`compile_trace` flattens the dynamic stream once and lowers every
   *unique static instruction* to a flat numeric record — op-class index,
   issue cost (stall + register-bank conflicts), scoreboard wait set,
   write/read barrier index, and signal latencies.  Records live in numpy
   arrays; the per-dynamic-position views the issue loop runs over are
   gathered with one fancy-index per field, so the hot loop touches no
   :class:`~repro_torch.core.isa.Instr` objects, no properties and no
   generator expressions.
2. :func:`_issue_loop` replays the exact scheduling semantics of the
   original cycle-by-cycle engine over those records, caching each warp's
   next-possible-issue time (it only changes when that warp issues — the
   scoreboard is per-warp state) and skipping idle spans to the next event.
   When the toolchain's C compiler is present (it is baked into the image)
   the loop runs as a natively compiled translation of the same algorithm
   (:mod:`repro_torch.core._native`); the pure-Python loop is the always-available
   fallback and the two are state-for-state identical.  Either engine can
   additionally capture **resumable checkpoints** at trace-position
   milestones and later resume from one, so re-simulating a kernel whose
   schedule only changed in a suffix replays only the suffix
   (:class:`SimCheckpoint` / :class:`CheckpointStore`;
   ``repro_torch.core.simcache.SimCache`` persists these alongside results).

Every acceleration is exact: the golden parity test pins
``simulate() == simulate_reference()`` cycle-for-cycle across every paper
benchmark × variant, and property tests drive random kernels through
checkpointed, batched and profiled runs against the reference engine.
:func:`simulate_batch` runs a set of sibling variants through one
checkpoint store in prefix-sharing order — the search's confirm stage and
``make_variants`` scoring cost one sweep instead of N cold runs.
"""

from __future__ import annotations

import heapq
import warnings
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.obs.stallprof import R_BANK, R_BAR, R_MEM, R_STALL, R_UNIT, StallProfile

from .isa import Instr, Kernel, Label, NUM_BARRIERS, OpClass
from .occupancy import Occupancy, SMConfig, occupancy_of

#: per-class issue interval in cycles per warp-instruction:
#: 32 lanes-per-warp / unit lanes (Maxwell table; per-arch values come
#: from the :mod:`repro_torch.arch` registry).
ISSUE_INTERVAL: Dict[OpClass, float] = {
    OpClass.FP32: 32 / 128,
    OpClass.INT: 32 / 128,
    OpClass.FP64: 32 / 4,
    OpClass.SFU: 32 / 32,
    OpClass.LSU_GLOBAL: 32 / 32,
    OpClass.LSU_SHARED: 32 / 32,
    OpClass.LSU_LOCAL: 32 / 32,
    OpClass.CONTROL: 32 / 128,
    OpClass.MISC: 32 / 32,
}

#: number of warp schedulers per SM (Maxwell: 4, single-issue modelled)
ISSUE_WIDTH = 4

#: barrier signal latency per class (producer completion).  Local-memory
#: traffic is L1-cached on Maxwell, so its *effective* latency sits between
#: shared memory and DRAM — the paper's whole premise is the ordering
#: shared (24) < local (cached, ~80) < global (200).
LOCAL_EFFECTIVE_LATENCY = 80


def _arch_of(kernel: Kernel):
    from repro_torch.arch import arch_of

    return arch_of(kernel)


def _signal_latency(ins: Instr, arch=None) -> int:
    k = ins.info.klass
    if arch is not None:
        return arch.signal_latency(k)
    if k is OpClass.LSU_GLOBAL:
        return 200
    if k is OpClass.LSU_LOCAL:
        return LOCAL_EFFECTIVE_LATENCY
    if k is OpClass.LSU_SHARED:
        return 24
    return k.latency


class Trace(list):
    """Dynamic instruction stream of one warp.

    A plain list of :class:`~repro_torch.core.isa.Instr` with one extra bit:
    ``truncated`` is True when the expansion hit ``max_len`` and the tail
    was dropped — capped simulations must be visible, never silent.
    """

    truncated: bool = False


#: kernels already warned about a truncated trace (one warning per kernel
#: per process; the telemetry counter counts every occurrence)
_TRUNCATION_WARNED: set = set()


def flatten_trace(kernel: Kernel, max_len: int = 200_000) -> "Trace":
    """Expand the dynamic instruction stream of one warp.

    Backward branches with ``trip_count`` metadata loop that many times;
    unpredicated forward branches are taken; predicated forward branches
    fall through (SIMT serialization of the cold path is approximated by
    the predicated instructions already present in the stream).

    An expansion longer than ``max_len`` is truncated there, with the cap
    made visible three ways (no-silent-caps rule): the returned
    :class:`Trace` has ``truncated=True`` (propagated to
    ``SimResult.truncated``), the ``simulator.trace_truncated`` telemetry
    counter increments, and a one-time-per-kernel warning is emitted.
    """
    labels = {it.name: i for i, it in enumerate(kernel.items) if isinstance(it, Label)}
    trace = Trace()
    counters: Dict[int, int] = {}
    pc = 0
    while pc < len(kernel.items):
        it = kernel.items[pc]
        if isinstance(it, Label):
            pc += 1
            continue
        ins: Instr = it
        if len(trace) >= max_len:
            trace.truncated = True
            if obs.enabled():
                obs.metrics().counter("simulator.trace_truncated").inc()
            if kernel.name not in _TRUNCATION_WARNED:
                _TRUNCATION_WARNED.add(kernel.name)
                warnings.warn(
                    f"{kernel.name}: dynamic trace exceeds {max_len} "
                    f"instructions; simulation runs on the truncated prefix "
                    f"(SimResult.truncated=True)",
                    RuntimeWarning,
                    stacklevel=2,
                )
            break
        trace.append(ins)
        if ins.info.is_exit:
            break
        if ins.info.is_branch:
            tgt = labels[ins.target]
            if ins.trip_count is not None and tgt < pc:
                n = counters.get(ins.uid, 0) + 1
                counters[ins.uid] = n
                if n < ins.trip_count:
                    pc = tgt
                else:
                    counters[ins.uid] = 0
                    pc += 1
            elif ins.pred is None:
                pc = tgt
            else:
                pc += 1
            continue
        pc += 1
    return trace


@dataclass
class SimResult:
    kernel_name: str
    cycles_per_wave: int
    waves: float
    total_cycles: int
    occupancy: Occupancy
    dynamic_instructions: int
    issue_stalls: int  # cycles where no warp could issue
    #: per-instruction, per-reason attribution of ``issue_stalls`` — filled
    #: only by ``simulate(..., profile=True)``; its total balances exactly
    #: against ``issue_stalls``
    stall_profile: Optional[StallProfile] = None
    #: True when the dynamic trace hit the ``flatten_trace`` length cap and
    #: the simulation ran on a truncated prefix
    truncated: bool = False


#: stable integer index per op class (trace-record encoding)
_KLASS_INDEX: Dict[OpClass, int] = {k: i for i, k in enumerate(OpClass)}

#: per-class issue interval, indexed by class index
_KLASS_INTERVAL: List[float] = [ISSUE_INTERVAL[k] for k in OpClass]


@dataclass
class CompiledTrace:
    """Stage 1 output: the dynamic stream lowered to flat numeric records.

    ``code[i]`` indexes the record arrays for the i-th dynamic instruction;
    every unique static instruction is lowered exactly once, so loops cost
    one record however many times they expand.  All numeric fields are
    numpy int arrays (``len``, iteration and indexing behave like the
    former list encoding); ``waits`` stays a list of tuples — wait sets are
    ragged and consumed as tuples by the issue loop.
    """

    code: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    klass: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    cost: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    waits: List[Tuple[int, ...]] = field(default_factory=list)
    write_bar: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    read_bar: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    write_lat: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    read_lat: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    uid: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    conflicts: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    is_mem: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))

    def __len__(self) -> int:
        return len(self.code)


#: op-class indices whose barrier waits attribute as memory latency
_MEM_KLASS = {
    _KLASS_INDEX[OpClass.LSU_GLOBAL],
    _KLASS_INDEX[OpClass.LSU_SHARED],
    _KLASS_INDEX[OpClass.LSU_LOCAL],
}


def compile_trace(trace: List[Instr], arch=None) -> CompiledTrace:
    """Lower the dynamic stream to flat records (one per static instruction).

    ``arch`` supplies the machine model (bank conflicts, signal latencies,
    operand-read release cap); ``None`` keeps the Maxwell table."""
    code: List[int] = []
    klass: List[int] = []
    cost: List[int] = []
    waits: List[Tuple[int, ...]] = []
    write_bar: List[int] = []
    read_bar: List[int] = []
    write_lat: List[int] = []
    read_lat: List[int] = []
    uid: List[int] = []
    conflicts_l: List[int] = []
    is_mem: List[int] = []
    rec_of: Dict[int, int] = {}
    read_cap = 20 if arch is None else arch.latency.read_release
    for ins in trace:
        j = rec_of.get(ins.uid)
        if j is None:
            j = len(klass)
            rec_of[ins.uid] = j
            ctrl = ins.ctrl
            conflicts = (
                ins.reg_bank_conflicts() if arch is None else arch.bank_conflicts(ins)
            )
            ki = _KLASS_INDEX[ins.info.klass]
            klass.append(ki)
            cost.append(max(1, ctrl.stall) + conflicts)
            waits.append(tuple(sorted(ctrl.wait)))
            write_bar.append(-1 if ctrl.write_bar is None else ctrl.write_bar)
            read_bar.append(-1 if ctrl.read_bar is None else ctrl.read_bar)
            lat = _signal_latency(ins, arch)
            write_lat.append(lat)
            read_lat.append(min(lat, read_cap))
            uid.append(ins.uid)
            conflicts_l.append(conflicts)
            is_mem.append(1 if ki in _MEM_KLASS else 0)
        code.append(j)
    return CompiledTrace(
        code=np.asarray(code, dtype=np.int64),
        klass=np.asarray(klass, dtype=np.int64),
        cost=np.asarray(cost, dtype=np.int64),
        waits=waits,
        write_bar=np.asarray(write_bar, dtype=np.int64),
        read_bar=np.asarray(read_bar, dtype=np.int64),
        write_lat=np.asarray(write_lat, dtype=np.int64),
        read_lat=np.asarray(read_lat, dtype=np.int64),
        uid=np.asarray(uid, dtype=np.int64),
        conflicts=np.asarray(conflicts_l, dtype=np.int64),
        is_mem=np.asarray(is_mem, dtype=np.int64),
    )


def position_signatures(ct: CompiledTrace) -> List[tuple]:
    """Per-dynamic-position engine-visible signature of a compiled trace.

    ``sigs[p]`` captures everything the issue loop reads about position
    ``p`` — record index, op class, cost, wait set, barrier slots, signal
    latencies, conflicts and memory-ness.  Two compiled traces that agree
    on ``sigs[:F+1]`` evolve identically while every warp's pc stays
    ≤ ``F`` — this is the checkpoint-reuse validity condition (record
    indices are first-occurrence ordinals, so an equal signature prefix
    implies equal record numbering for every record referenced in it, which
    keeps stall-attribution keys portable too).

    The signature list is memoised on the trace and its element tuples are
    shared per record, so a 100k-position loopy trace costs one tuple per
    *static* instruction plus a pointer per position.
    """
    sigs = getattr(ct, "_pos_sigs", None)
    if sigs is None:
        klass = ct.klass.tolist()
        cost = ct.cost.tolist()
        wbar = ct.write_bar.tolist()
        rbar = ct.read_bar.tolist()
        wlat = ct.write_lat.tolist()
        rlat = ct.read_lat.tolist()
        confl = ct.conflicts.tolist()
        mem = ct.is_mem.tolist()
        rec_sigs = [
            (j, klass[j], cost[j], wbar[j], rbar[j], wlat[j], rlat[j],
             confl[j], mem[j], ct.waits[j])
            for j in range(len(ct.klass))
        ]
        sigs = [rec_sigs[j] for j in ct.code.tolist()]
        ct._pos_sigs = sigs
    return sigs


@dataclass
class SimCheckpoint:
    """A resumable issue-loop state, captured at a trace-position milestone.

    Valid to resume any kernel whose :func:`position_signatures` agree with
    the captured kernel's on ``[0, frontier]`` (no warp had advanced past
    ``frontier``), under the same (n_warps, intervals, issue_width,
    num_barriers) family, for any ``max_cycles`` greater than ``cycle``.
    ``profiled`` checkpoints carry the stall-attribution books and can seed
    both profiled and plain runs; unprofiled ones only seed plain runs (a
    profiled run resumed without its books could never balance).
    """

    frontier: int
    cycle: float
    idle_cycles: int
    rr: int
    pc: Tuple[int, ...]
    next_time: Tuple[float, ...]
    bars: Tuple[Tuple[float, ...], ...]
    unit_free: Tuple[float, ...]
    profiled: bool = False
    blame: Optional[Dict[Tuple[int, str], int]] = None
    warp_blame: Optional[Tuple[Tuple[int, str], ...]] = None
    bar_setter: Optional[Tuple[Tuple[int, ...], ...]] = None


class CheckpointStore:
    """Content-keyed store of :class:`SimCheckpoint` entries.

    Keys are ``(family, frontier, signature-prefix-tuple)`` — the full
    engine-visible prefix is the collision guard (a checkpoint is never
    served to a kernel it is not exactly valid for).  Signature tuples are
    shared per static record, so stored prefixes cost pointers, not copies.
    FIFO-bounded like the other caches; ``reuse_rate`` reports the
    position-weighted fraction of simulated work served from checkpoints.
    """

    def __init__(self, max_entries: Optional[int] = 256):
        self.max_entries = max_entries
        self._entries: Dict[tuple, SimCheckpoint] = {}
        #: family -> descending list of frontiers ever stored (probe order)
        self._lengths: Dict[tuple, List[int]] = {}
        self.hits = 0
        self.misses = 0
        self.positions_total = 0
        self.positions_resumed = 0

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def reuse_rate(self) -> float:
        """Fraction of dynamic trace positions skipped by resuming."""
        if not self.positions_total:
            return 0.0
        return self.positions_resumed / self.positions_total

    def lookup(
        self,
        family: tuple,
        sigs: List[tuple],
        max_cycles: int,
        profiled: bool,
    ) -> Optional[SimCheckpoint]:
        """Deepest stored checkpoint exactly valid for this trace, or None."""
        self.positions_total += len(sigs)
        for frontier in self._lengths.get(family, ()):
            if frontier + 1 >= len(sigs):
                continue
            cp = self._entries.get((family, frontier, tuple(sigs[: frontier + 1])))
            if cp is None or cp.cycle >= max_cycles:
                continue
            if profiled and not cp.profiled:
                continue
            self.hits += 1
            self.positions_resumed += frontier + 1
            if obs.enabled():
                obs.metrics().counter("simcache.ckpt_hits").inc()
            return cp
        self.misses += 1
        if obs.enabled():
            obs.metrics().counter("simcache.ckpt_misses").inc()
        return None

    def offer(
        self, family: tuple, sigs: List[tuple], checkpoints: Sequence[SimCheckpoint]
    ) -> int:
        """Adopt captured checkpoints; an existing entry is only replaced
        when the newcomer adds the stall-attribution books (a profiled
        checkpoint serves both engines, a plain one only the plain engine).
        Returns the number of entries stored."""
        added = 0
        for cp in checkpoints:
            key = (family, cp.frontier, tuple(sigs[: cp.frontier + 1]))
            old = self._entries.get(key)
            if old is not None and (old.profiled or not cp.profiled):
                continue
            if (
                old is None
                and self.max_entries is not None
                and len(self._entries) >= self.max_entries
            ):
                self._entries.pop(next(iter(self._entries)))
            self._entries[key] = cp
            lens = self._lengths.setdefault(family, [])
            if cp.frontier not in lens:
                lens.append(cp.frontier)
                lens.sort(reverse=True)
            added += 1
        return added

    def clear(self) -> None:
        self._entries.clear()
        self._lengths.clear()
        self.hits = 0
        self.misses = 0
        self.positions_total = 0
        self.positions_resumed = 0

    def stats(self) -> Dict[str, float]:
        return {
            "entries": len(self._entries),
            "hits": self.hits,
            "misses": self.misses,
            "reuse_rate": round(self.reuse_rate, 3),
        }


def _native_engine():
    """The compiled issue loop (``_sim_engine.c`` via :mod:`._native`), or
    ``None`` when unavailable / disabled — the Python loop then runs."""
    from . import _native

    return _native.engine()


#: trace-length fractions at which the issue loop captures checkpoints
_CKPT_FRACTIONS = (8, 4, 2)  # denominators: n/8, n/4, n/2 — plus 3n/4
#: traces shorter than this are not worth checkpointing
_CKPT_MIN_TRACE = 64


def _issue_loop(
    ct: CompiledTrace,
    n_warps: int,
    max_cycles: int,
    intervals: Optional[List[float]] = None,
    issue_width: int = ISSUE_WIDTH,
    num_barriers: int = NUM_BARRIERS,
    blame: Optional[Dict[Tuple[int, str], int]] = None,
    resume: Optional[SimCheckpoint] = None,
    capture: Optional[List[SimCheckpoint]] = None,
) -> Tuple[float, int]:
    """Stage 2: the event-driven issue loop; returns (cycles, idle_cycles).

    Cycle-exact replay of the reference engine's semantics: warps round-robin
    under an issue width of 4, per-class unit capacity gates issue, and a
    cycle in which nothing issues jumps straight to the next warp-ready
    event.  A warp's earliest issue time is cached — the scoreboard is
    per-warp state, so it can only change when that warp itself issues; a
    finished warp parks at ``inf``.

    ``blame`` (optional) turns on stall attribution: every idle cycle the
    loop counts is also charged to exactly one ``(record_index, reason)``
    key in the dict — the scheduling decisions themselves are untouched, so
    a profiled run is cycle-identical to an unprofiled one.  At issue time
    each warp remembers *why* it will next be blocked (its own stall
    count / bank conflicts, or a scoreboard barrier and that barrier's
    setter); at idle time the warp whose event bounds the jump donates its
    recorded reason, and ready-but-unit-blocked warps charge the busy
    unit's instruction instead.

    ``resume`` (optional) starts the loop from a previously captured
    :class:`SimCheckpoint` instead of cycle 0; ``capture`` (optional) is a
    list the loop appends fresh checkpoints to as the position frontier
    crosses trace-length milestones.  Both are exact: a resumed run
    finishes in the state a cold run would have reached.

    When the native engine is available (:mod:`repro_torch.core._native`) the
    whole loop — blame, resume and capture included — runs compiled; this
    Python body is the fallback and the conformance reference for it.
    """
    native = _native_engine()
    if native is not None:
        return native(
            ct, n_warps, max_cycles, intervals, issue_width, num_barriers,
            blame, resume, capture,
        )
    n_trace = len(ct.code)
    if n_trace == 0:
        return 0.0, 0
    # per-dynamic-position record fields: one numpy gather per field, then
    # plain lists for the scalar hot loop (list indexing beats ndarray
    # scalar indexing by a wide margin in CPython)
    code_a = ct.code
    code = code_a.tolist()
    p_klass = ct.klass[code_a].tolist()
    p_cost = ct.cost[code_a].tolist()
    p_wbar = ct.write_bar[code_a].tolist()
    p_rbar = ct.read_bar[code_a].tolist()
    p_wlat = ct.write_lat[code_a].tolist()
    p_rlat = ct.read_lat[code_a].tolist()
    #: wait set of the *next* position (what the issuing warp blocks on);
    #: empty tuple past the end
    p_next_waits = [ct.waits[j] for j in code[1:]] + [()]
    if intervals is None:
        intervals = _KLASS_INTERVAL

    pc = [0] * n_warps
    bars = [[0.0] * num_barriers for _ in range(n_warps)]
    #: earliest cycle each warp can issue its next instruction (inf = done)
    next_time = [0.0] * n_warps
    n_done = 0
    unit_free = [0.0] * len(intervals)
    cycle = 0.0
    idle_cycles = 0
    rr = 0
    inf = float("inf")

    # stall-attribution state (profiled runs only): per-warp barrier setter
    # records and the (record, reason) each blocked warp would charge
    if blame is not None:
        rec_conflicts = ct.conflicts
        rec_mem = ct.is_mem
        bar_setter = [[-1] * num_barriers for _ in range(n_warps)]
        warp_blame: List[Tuple[int, str]] = [(code[0], R_STALL)] * n_warps

    frontier = 0
    if resume is not None:
        pc = list(resume.pc)
        next_time = list(resume.next_time)
        bars = [list(bw) for bw in resume.bars]
        unit_free = list(resume.unit_free)
        cycle = resume.cycle
        idle_cycles = resume.idle_cycles
        rr = resume.rr
        frontier = resume.frontier
        if blame is not None:
            blame.update(resume.blame)
            warp_blame = list(resume.warp_blame)
            bar_setter = [list(bs) for bs in resume.bar_setter]

    # event-driven ready tracking: a per-class bitmask of ready warps (bit w
    # set = warp w's next instruction is class c and its scoreboard allows
    # issue) plus a min-heap of (wake time, warp) for blocked warps.  The
    # issue scan walks set bits in round-robin rotation instead of scanning
    # every warp every cycle, so a unit-saturated cycle costs O(classes);
    # heap tuple order (time, warp) reproduces the reference engine's
    # first-strict-minimum tie-breaking exactly.
    heappush = heapq.heappush
    heappop = heapq.heappop
    n_classes = len(intervals)
    class_masks = [0] * n_classes
    heap: List[Tuple[float, int]] = []
    for w in range(n_warps):
        v = next_time[w]
        if v <= cycle:
            class_masks[p_klass[pc[w]]] |= 1 << w
        else:
            heap.append((v, w))
    if heap:
        heapq.heapify(heap)
    full_mask = (1 << n_warps) - 1

    # checkpoint capture milestones (positions the frontier must cross)
    thresholds: List[int] = []
    if capture is not None and n_trace >= _CKPT_MIN_TRACE:
        marks = {n_trace // d for d in _CKPT_FRACTIONS}
        marks.add((3 * n_trace) // 4)
        thresholds = sorted(m for m in marks if frontier < m < n_trace)

    while n_done < n_warps and cycle < max_cycles:
        while heap and heap[0][0] <= cycle:
            _, w = heappop(heap)
            class_masks[p_klass[pc[w]]] |= 1 << w
        if thresholds and n_done == 0 and frontier >= thresholds[0]:
            while thresholds and frontier >= thresholds[0]:
                thresholds.pop(0)
            capture.append(
                SimCheckpoint(
                    frontier=frontier,
                    cycle=cycle,
                    idle_cycles=idle_cycles,
                    rr=rr,
                    pc=tuple(pc),
                    next_time=tuple(next_time),
                    bars=tuple(tuple(bw) for bw in bars),
                    unit_free=tuple(unit_free),
                    profiled=blame is not None,
                    blame=dict(blame) if blame is not None else None,
                    warp_blame=tuple(warp_blame) if blame is not None else None,
                    bar_setter=(
                        tuple(tuple(bs) for bs in bar_setter)
                        if blame is not None
                        else None
                    ),
                )
            )
        cap = cycle + 1
        # classes whose unit still has capacity this cycle contribute their
        # ready warps to the eligible set
        elig = 0
        for c in range(n_classes):
            m = class_masks[c]
            if m and unit_free[c] < cap:
                elig |= m
        if elig:
            # visit eligible warps in round-robin rotation: bit i of the
            # rotated mask is warp (rr + i) mod n_warps, and extracting
            # ascending set bits replays the reference scan order exactly
            rot = ((elig >> rr) | (elig << (n_warps - rr))) & full_mask
            issued = 0
            while rot:
                lsb = rot & -rot
                w = lsb.bit_length() - 1 + rr
                if w >= n_warps:
                    w -= n_warps
                p = pc[w]
                ki = p_klass[p]
                uf = unit_free[ki]
                # the unit blocks only once this cycle's capacity is spent;
                # a class saturated mid-cycle drops all its pending warps
                # from the rotation, exactly as the reference skips them
                if uf >= cap:
                    cm = class_masks[ki]
                    rot &= ~(((cm >> rr) | (cm << (n_warps - rr))) & full_mask)
                    continue
                # ---- issue -------------------------------------------------
                rot ^= lsb
                issued += 1
                class_masks[ki] &= ~(1 << w)
                unit_free[ki] = (uf if uf > cycle else cycle) + intervals[ki]
                t = cycle + p_cost[p]
                bw = bars[w]
                b = p_wbar[p]
                if b >= 0:
                    bw[b] = cycle + p_wlat[p]
                b = p_rbar[p]
                if b >= 0:
                    # operands are read shortly after issue
                    bw[b] = cycle + p_rlat[p]
                if blame is not None:
                    j = code[p]
                    bs = bar_setter[w]
                    if p_wbar[p] >= 0:
                        bs[p_wbar[p]] = j
                    if p_rbar[p] >= 0:
                        bs[p_rbar[p]] = j
                p += 1
                pc[w] = p
                if p > frontier:
                    frontier = p
                if p >= n_trace:
                    n_done += 1
                    next_time[w] = inf
                elif blame is None:
                    ws = p_next_waits[p - 1]
                    if ws:
                        for b in ws:
                            v = bw[b]
                            if v > t:
                                t = v
                    next_time[w] = t
                    heappush(heap, (t, w))
                else:
                    # same wait maximization, additionally tracking which
                    # event bounds t: the issued instruction's own cost
                    # (stall / bank conflict) or a barrier and its setter
                    j = code[p - 1]
                    rec = j
                    reason = R_BANK if rec_conflicts[j] else R_STALL
                    bs = bar_setter[w]
                    for b in p_next_waits[p - 1]:
                        v = bw[b]
                        if v > t:
                            t = v
                            sj = bs[b]
                            if sj >= 0:
                                rec = sj
                                reason = R_MEM if rec_mem[sj] else R_BAR
                    next_time[w] = t
                    heappush(heap, (t, w))
                    warp_blame[w] = (rec, reason)
                if issued >= issue_width:
                    break
            rr += 1
            if rr >= n_warps:
                rr = 0
            cycle += 1
        else:
            # Jump to the next time anything can happen.  Two distinct idle
            # shapes, both replayed exactly as the reference engine counts
            # them (done warps are in neither the masks nor the heap; the
            # loop guard ensures at least one warp is live):
            #
            # * no warp is ready: one reference iteration jumps straight to
            #   the earliest warp-ready event (rr advances once);
            # * some warp is ready but its unit is at capacity: the
            #   reference crawls cycle-by-cycle (rr and idle advance per
            #   cycle) until a unit frees (cycle + 1 > unit_free, i.e. at
            #   floor(unit_free)) or another warp becomes ready — nothing
            #   can issue in between, so the k crawl cycles collapse into
            #   one iteration with rr += k and idle += k.
            #
            # The heap top is the earliest blocked-warp event with the
            # reference's first-strict-minimum warp tie-break ((time, warp)
            # tuple order); the block bound scans classes, and the owning
            # warp (attribution only) is the lowest set bit over the
            # minimum's classes — the first warp the reference would have
            # recorded.
            rr += 1
            if rr >= n_warps:
                rr = 0
            mn_wait = heap[0][0] if heap else inf
            mn_block = inf  # earliest unit-free event of a ready warp
            blk_mask = 0    # ready warps of the classes bounding mn_block
            for c in range(n_classes):
                m = class_masks[c]
                if not m:
                    continue
                v = float(int(unit_free[c]))
                if v < mn_block:
                    mn_block = v
                    blk_mask = m
                elif v == mn_block:
                    blk_mask |= m
            if mn_block < inf:
                nxt = mn_block if mn_block < mn_wait else mn_wait
                if nxt < cap:
                    nxt = cap
                elif nxt > max_cycles:
                    # the reference crawls one cycle per iteration and stops
                    # exactly at the cap — clamp the bulk jump likewise
                    nxt = float(max_cycles)
                k = int(nxt - cycle)
                idle_cycles += k
                rr += k - 1
                rr %= n_warps
                if blame is not None and k:
                    if mn_block <= mn_wait:
                        w_block = (blk_mask & -blk_mask).bit_length() - 1
                        key = (code[pc[w_block]], R_UNIT)
                    else:
                        key = warp_blame[heap[0][1]]
                    blame[key] = blame.get(key, 0) + k
            else:
                nxt = mn_wait if mn_wait > cap else cap
                k = int(nxt - cycle)
                idle_cycles += k
                if blame is not None and k:
                    key = warp_blame[heap[0][1]]
                    blame[key] = blame.get(key, 0) + k
            cycle = nxt
    return cycle, idle_cycles


def _engine_family(n_warps: int, intervals: List[float], arch) -> tuple:
    """Checkpoint compatibility key: everything the issue loop's evolution
    depends on besides the compiled trace itself."""
    return (n_warps, tuple(intervals), arch.issue_width, arch.num_barriers)


def simulate(
    kernel: Kernel,
    sm: Optional[SMConfig] = None,
    max_cycles: int = 50_000_000,
    profile: bool = False,
    checkpoints: Optional[CheckpointStore] = None,
    _prep: Optional[tuple] = None,
) -> SimResult:
    """Simulate one wave of resident warps on one SM; scale by wave count.

    Two-stage engine: :func:`compile_trace` lowers the dynamic stream to
    flat numeric records, :func:`_issue_loop` replays the scheduling
    semantics event-to-event.  Cycle-exact with :func:`simulate_reference`.

    The machine model (unit lanes, latencies, issue width) comes from the
    kernel's architecture; ``sm`` overrides the occupancy limits only
    (default: the arch's own SMConfig), which permits deliberate
    cross-arch what-ifs like ``simulate(volta_kernel, MAXWELL)``.

    ``profile=True`` additionally attributes every idle cycle to a static
    instruction and a reason (:class:`repro_torch.obs.stallprof.StallProfile` on
    ``SimResult.stall_profile``); the attribution is bookkeeping only —
    cycle counts are identical either way, and the profile total balances
    exactly against ``issue_stalls``.

    ``checkpoints`` (optional) plugs in a :class:`CheckpointStore`: the run
    resumes from the deepest exactly-valid captured state and contributes
    fresh captures back — incremental re-simulation for kernels that share
    a schedule prefix (``SimCache`` wires its own store through here).

    ``_prep`` is internal: :func:`simulate_batch` already flattened and
    compiled every member's trace to order the batch, and hands the work
    over instead of paying the trace compiler twice per kernel.
    """
    with obs.span("simulate", kernel=kernel.name, profile=profile) as sp:
        if _prep is not None:
            arch, sm, occ, trace, ct = _prep
        else:
            arch = _arch_of(kernel)
            if sm is None:
                sm = arch.sm
            occ = occupancy_of(kernel, sm)
            trace = flatten_trace(kernel)
            ct = compile_trace(trace, arch)
        n_warps = max(occ.resident_warps, 1)
        intervals = [arch.issue_interval(k) for k in OpClass]
        blame: Optional[Dict[Tuple[int, str], int]] = {} if profile else None
        resume = None
        capture: Optional[List[SimCheckpoint]] = None
        family = sigs = None
        if checkpoints is not None:
            sigs = position_signatures(ct)
            family = _engine_family(n_warps, intervals, arch)
            resume = checkpoints.lookup(family, sigs, max_cycles, profile)
            capture = []
        cycle, idle_cycles = _issue_loop(
            ct, n_warps, max_cycles, intervals, arch.issue_width,
            arch.num_barriers, blame, resume=resume, capture=capture,
        )
        if checkpoints is not None and capture:
            checkpoints.offer(family, sigs, capture)

        stall_profile = None
        if profile:
            from repro_torch.obs.stallprof import build_profile

            by_uid: Dict[Tuple[int, str], int] = {}
            uid = ct.uid.tolist()
            for (rec, reason), c in blame.items():
                key = (uid[rec], reason)
                by_uid[key] = by_uid.get(key, 0) + c
            stall_profile = build_profile(kernel, by_uid, idle_cycles)

        # fractional waves: charge the launch by work/throughput, not by
        # rounding partial waves up (a 1.2-wave launch is not 2x a 1.0-wave
        # launch)
        blocks_per_wave = max(occ.resident_blocks, 1) * sm.num_sms
        waves = kernel.num_blocks / blocks_per_wave
        sp.set(cycles=int(cycle), warps=n_warps, instrs=len(trace))
        return SimResult(
            kernel_name=kernel.name,
            cycles_per_wave=int(cycle),
            waves=max(1.0, waves),
            total_cycles=int(cycle * max(1.0, waves)),
            occupancy=occ,
            dynamic_instructions=len(trace),
            issue_stalls=idle_cycles,
            stall_profile=stall_profile,
            truncated=trace.truncated,
        )


def simulate_batch(
    kernels: Sequence[Kernel],
    sm: Optional[SMConfig] = None,
    max_cycles: int = 50_000_000,
    profile: bool = False,
    cache=None,
    checkpoints: Optional[CheckpointStore] = None,
) -> List[SimResult]:
    """Simulate a batch of sibling kernels through one checkpoint store.

    Element-wise identical to calling :func:`simulate` per kernel (the
    differential property test pins this, stall books included) — the win
    is scheduling: kernels are visited in signature-prefix order, so each
    run resumes from the deepest checkpoint its predecessors captured, and
    variants that only diverge in a schedule suffix replay only the suffix.

    ``cache`` (optional, a ``repro_torch.core.simcache.SimCache``) serves and
    warms full results too, which additionally dedups content-identical
    batch members; otherwise ``checkpoints`` (default: a fresh private
    store) carries the intra-batch reuse.
    """
    kernels = list(kernels)
    if not kernels:
        return []
    with obs.span("simulate_batch", kernels=len(kernels), profile=profile):
        if checkpoints is None:
            checkpoints = (
                cache.checkpoints if cache is not None else CheckpointStore()
            )
        order = []
        preps = []
        for i, k in enumerate(kernels):
            arch = _arch_of(k)
            sm_k = sm if sm is not None else arch.sm
            occ = occupancy_of(k, sm_k)
            trace = flatten_trace(k)
            ct = compile_trace(trace, arch)
            intervals = [arch.issue_interval(kl) for kl in OpClass]
            family = _engine_family(max(occ.resident_warps, 1), intervals, arch)
            order.append((family, position_signatures(ct), i))
            preps.append((arch, sm_k, occ, trace, ct))
        order.sort(key=lambda t: (t[0], t[1]))
        results: List[Optional[SimResult]] = [None] * len(kernels)
        for _, _, i in order:
            k = kernels[i]
            if cache is not None:
                if profile:
                    prof = cache.profile(k, sm, max_cycles)
                    res = cache.simulate(k, sm, max_cycles)
                    res.stall_profile = prof
                else:
                    res = cache.simulate(k, sm, max_cycles)
            else:
                res = simulate(
                    k, sm, max_cycles, profile, checkpoints, _prep=preps[i]
                )
            results[i] = res
        return results


def simulate_reference(
    kernel: Kernel,
    sm: Optional[SMConfig] = None,
    max_cycles: int = 50_000_000,
) -> SimResult:
    """The pre-optimization cycle-by-cycle engine, kept verbatim as the
    parity oracle for :func:`simulate` (golden test: identical cycles).

    Arch-parameterized the same way as :func:`simulate`, so the parity
    holds per architecture."""
    arch = _arch_of(kernel)
    if sm is None:
        sm = arch.sm
    issue_width = arch.issue_width
    num_barriers = arch.num_barriers
    issue_interval = {k: arch.issue_interval(k) for k in OpClass}
    occ = occupancy_of(kernel, sm)
    trace = flatten_trace(kernel)
    n_warps = max(occ.resident_warps, 1)

    # per-warp state
    pc = [0] * n_warps
    ready = [0.0] * n_warps  # earliest issue cycle
    bar_signal = [[0.0] * num_barriers for _ in range(n_warps)]
    done = [False] * n_warps
    n_done = 0

    unit_free: Dict[OpClass, float] = {k: 0.0 for k in OpClass}
    cycle = 0.0
    idle_cycles = 0
    rr = 0  # round-robin pointer

    def warp_next_time(w: int) -> float:
        """Earliest cycle warp ``w`` could issue its next instruction."""
        t = ready[w]
        ins = trace[pc[w]]
        for b in ins.ctrl.wait:
            t = max(t, bar_signal[w][b])
        return t

    while n_done < n_warps and cycle < max_cycles:
        issued = 0
        for k in range(n_warps):
            if issued >= issue_width:
                break
            w = (rr + k) % n_warps
            if done[w]:
                continue
            ins = trace[pc[w]]
            if ready[w] > cycle:
                continue
            if any(bar_signal[w][b] > cycle for b in ins.ctrl.wait):
                continue
            klass = ins.info.klass
            # the unit blocks only once this cycle's issue capacity is spent
            # (e.g. FP32 interval 0.25 -> four issues per cycle)
            if unit_free[klass] >= cycle + 1:
                continue
            # ---- issue -----------------------------------------------------
            issued += 1
            unit_free[klass] = max(unit_free[klass], cycle) + issue_interval[klass]
            issue_cost = max(1, ins.ctrl.stall) + arch.bank_conflicts(ins)
            ready[w] = cycle + issue_cost
            if ins.ctrl.write_bar is not None:
                bar_signal[w][ins.ctrl.write_bar] = cycle + _signal_latency(ins, arch)
            if ins.ctrl.read_bar is not None:
                # operands are read shortly after issue
                bar_signal[w][ins.ctrl.read_bar] = cycle + min(
                    _signal_latency(ins, arch), arch.latency.read_release
                )
            pc[w] += 1
            if pc[w] >= len(trace):
                done[w] = True
                n_done += 1
        rr = (rr + 1) % n_warps
        if issued == 0:
            # jump to the next time anything can happen
            nxt = min(
                (warp_next_time(w) for w in range(n_warps) if not done[w]),
                default=cycle + 1,
            )
            nxt = max(nxt, cycle + 1)
            idle_cycles += int(nxt - cycle)
            cycle = nxt
        else:
            cycle += 1

    # fractional waves: charge the launch by work/throughput, not by rounding
    # partial waves up (a 1.2-wave launch is not 2x a 1.0-wave launch)
    blocks_per_wave = max(occ.resident_blocks, 1) * sm.num_sms
    waves = kernel.num_blocks / blocks_per_wave
    return SimResult(
        kernel_name=kernel.name,
        cycles_per_wave=int(cycle),
        waves=max(1.0, waves),
        total_cycles=int(cycle * max(1.0, waves)),
        occupancy=occ,
        dynamic_instructions=len(trace),
        issue_stalls=idle_cycles,
        truncated=trace.truncated,
    )


def speedup(base: SimResult, other: SimResult) -> float:
    """Speedup of ``other`` over ``base`` (>1 means faster).

    A zero-cycle denominator (an empty or fully truncated-away kernel) has
    no meaningful ratio; that is an explicit error, never a
    ZeroDivisionError from deep inside a report."""
    if other.total_cycles == 0:
        raise ValueError(
            f"speedup undefined: {other.kernel_name} simulated to 0 cycles"
        )
    return base.total_cycles / other.total_cycles
