"""The unified spill-transform pass pipeline (paper §3 machinery).

Every spilling flow in this repo — RegDem demotion (:func:`repro_torch.core.
regdem.demote`), the nvcc ``--maxrregcount`` model (:func:`repro_torch.core.
variants.aggressive`), the Hayes & Zhang local→shared conversion, and the
pyReDe translator's variant enumeration — is one machine: reserve scratch
registers, emit an addressing prologue, move register words into a
:class:`~repro_torch.core.spillspace.SpillSpace`, then clean up (redundancy
elimination, compaction, substitution, rescheduling, stall fixup).  This
module expresses that machine once:

* :class:`Pass`          one named transformation over a :class:`PassContext`;
* :class:`PassContext`   kernel + spill space + reserved registers +
                         candidate queue + per-pass diagnostics/timings;
* :class:`PassPipeline`  runs a pass schedule and, after **every** pass,
                         the schedule verifier and the dataflow-equivalence
                         oracle (``verify="each"``, the default) — a pipeline
                         that corrupts a kernel mid-flight fails loudly at
                         the exact pass that broke it.

The concrete passes mirror the paper's transformation stack: prologue
(§3.2), per-register demotion (Fig. 3), rematerialization (§5.3's nvcc
model), redundancy elimination (§3.4.2 pass 1), compaction (§3.3),
substitution (§3.4.2 pass 3), rescheduling (§3.4.2 pass 2), stall fixup.
:func:`demotion_pipeline` and :func:`aggressive_pipeline` assemble the two
schedules; ``demote()``/``aggressive()``/``make_variants()``/``translate()``
are thin configurations of them.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

from repro_torch import obs

from .candidates import make_candidates, operand_conflicts
from .compaction import compact, packed_reg_count
from .isa import (
    RZ,
    Instr,
    Kernel,
    Label,
    equivalent,
)
from .sched import _blocks, fixup_stalls, repair_war, verify_block
from .spillspace import SpillSpace

#: Hard floor below which demotion gives no occupancy benefit (paper §3).
REG_FLOOR = 32

#: Process-wide pipeline execution counters (observability; the translation
#: cache's acceptance test reads these to prove a cache hit ran zero passes).
PIPELINE_COUNTERS = {"pipelines": 0, "passes": 0}


class PassVerificationError(RuntimeError):
    """A pipeline self-check failed: the named pass broke the kernel."""


# ---------------------------------------------------------------------------
# Incremental verification signatures
# ---------------------------------------------------------------------------
#
# The pipeline's self-checks are incremental: each check records what it
# proved, keyed by content signatures, so the next check only re-analyzes
# what a pass actually touched.
#
# * The *schedule* verifier is per-barrier-scope local (barriers never span
#   scopes), so only scopes whose scheduling signature changed re-verify.
# * The *dataflow* oracle (interpreter equivalence vs the original) is
#   whole-program, but a pass that leaves every semantic field untouched —
#   e.g. a stall fixup, which edits only control words — cannot change
#   dataflow, so the oracle is skipped while the semantic signature of the
#   kernel matches the last proven-equivalent state.
#
# Signatures are full tuples (not hashes): a skipped check must imply true
# content identity, never a hash coincidence.


def _sem_sig_item(it) -> tuple:
    """Everything the scalar interpreter can observe about one stream item."""
    if isinstance(it, Label):
        return ("L", it.name)
    return (
        it.op, tuple(it.dsts), tuple(it.srcs), it.imm, it.offset, it.target,
        it.pred, it.pred_neg, it.pdst, it.trip_count,
    )


def _sem_signature(kernel: Kernel) -> tuple:
    """Semantic content of the whole kernel (dataflow-oracle inputs)."""
    return (
        tuple(_sem_sig_item(it) for it in kernel.items),
        frozenset(kernel.live_in),
        frozenset(kernel.live_out),
    )


def _sched_signature(block: List[Instr]) -> tuple:
    """Schedule-verifier-visible content of one barrier scope."""
    return tuple(
        (
            _sem_sig_item(i),
            i.ctrl.stall,
            i.ctrl.write_bar,
            i.ctrl.read_bar,
            tuple(sorted(i.ctrl.wait)),
        )
        for i in block
    )


@dataclass
class RegDemOptions:
    """Optimization options (the paper's exhaustive-search dimensions)."""

    candidate_strategy: str = "cfg"      # §3.4.3 (Fig. 8)
    bank_avoid: bool = True              # §3.4.1 (Fig. 7)
    elim_redundant: bool = True          # §3.4.2 pass 1 (Fig. 7)
    reschedule: bool = True              # §3.4.2 pass 2 (Fig. 7)
    substitute: bool = True              # §3.4.2 pass 3 (Fig. 7)

    def label(self) -> str:
        flags = "".join(
            "1" if f else "0"
            for f in (self.bank_avoid, self.elim_redundant, self.reschedule, self.substitute)
        )
        return f"{self.candidate_strategy}:{flags}"


@dataclass
class PassStat:
    """One executed pass: wall time plus whatever the pass reported."""

    name: str
    seconds: float
    stats: Dict[str, int] = field(default_factory=dict)

    def describe(self) -> str:
        body = " ".join(f"{k}={v}" for k, v in sorted(self.stats.items()))
        return f"{self.name}: {self.seconds * 1e3:.2f}ms {body}".rstrip()


def stats_by_pass(passes: Sequence[PassStat]) -> Dict[str, Dict[str, int]]:
    """Executed-pass stats keyed by pass name, duplicates preserved.

    A schedule may legitimately run the same pass more than once (e.g. a
    tuning pipeline that re-runs ``fixup_stalls``); re-runs get ``#2``,
    ``#3``, ... suffixes in execution order instead of silently overwriting
    the first run's numbers.
    """
    out: Dict[str, Dict[str, int]] = {}
    seen: Dict[str, int] = {}
    for p in passes:
        n = seen.get(p.name, 0) + 1
        seen[p.name] = n
        key = p.name if n == 1 else f"{p.name}#{n}"
        out[key] = dict(p.stats)
    return out


class PassContext:
    """Everything the passes share for one spilling run over one kernel.

    The context owns a *copy* of the input kernel (``self.kernel``) and keeps
    the untouched original (``self.original``) for the pipeline's
    dataflow-equivalence self-check.
    """

    def __init__(
        self,
        kernel: Kernel,
        space: SpillSpace,
        options: Optional[RegDemOptions] = None,
        target: int = REG_FLOOR,
        floor: Optional[int] = None,
        max_remat: Optional[int] = None,
        select: Optional[Callable[[Kernel], List[Tuple[int, int]]]] = None,
    ):
        self.original = kernel
        self.kernel = kernel.copy()
        self.space = space
        self.options = options or RegDemOptions()
        self.target = target
        #: the kernel's architecture descriptor — parameterizes barrier
        #: tracking, register banking, and the spill budget for every pass
        from repro_torch.arch import arch_of

        self.arch = arch_of(kernel)
        #: register count at which spilling stops; RegDem clamps to
        #: REG_FLOOR (no occupancy benefit below 32), the aggressive
        #: allocator honours the raw target like nvcc does
        self.floor = max(target, REG_FLOOR) if floor is None else floor
        self.max_remat = max_remat

        #: ordered demotion queue [(leading_reg, width)], pruned as passes
        #: run.  ``select`` overrides the default queue builder — registered
        #: strategies (:mod:`repro_torch.core.strategies`) use it to filter or
        #: reorder candidates beyond the paper's three orderings.
        self.candidates: List[Tuple[int, int]] = (
            select(self.kernel)
            if select is not None
            else make_candidates(self.kernel, self.options.candidate_strategy)
        )
        self.conflicts: Dict[int, Set[int]] = operand_conflicts(self.kernel)

        # reserved registers (filled by ReserveRegistersPass)
        self.rdv: int = RZ          # demoted-value register
        self.rda: int = RZ          # demoted-base-address register
        self.rtmp: Optional[int] = None  # rematerialization temporary
        self.wide: bool = False     # RDV is an even-aligned pair

        # outcome accumulators
        self.demoted: List[Tuple[int, int]] = []   # (original reg, width)
        self.demoted_words: int = 0
        self.remat: int = 0
        self.rematted: Set[int] = set()

        #: per-pass diagnostics/timings, in execution order
        self.passes: List[PassStat] = []

        # incremental-verification state: per-scope schedule signatures last
        # proven valid (None = nothing proven yet) and the semantic signature
        # last proven dataflow-equivalent to the original (the fresh copy is
        # equivalent by construction)
        self._sched_sigs: Optional[List[tuple]] = None
        self._sem_verified: tuple = _sem_signature(self.kernel)

    def pass_stats(self) -> Dict[str, Dict[str, int]]:
        """Per-pass stats keyed by pass name; a re-run pass gets a ``#n``
        suffix (see :func:`stats_by_pass`) instead of clobbering the first
        run's numbers."""
        return stats_by_pass(self.passes)


class Pass:
    """One named, self-contained transformation over a :class:`PassContext`.

    Subclasses set :attr:`name` and implement :meth:`run`, returning a stats
    dict (or ``None``) that the pipeline records with the pass timing.
    """

    name: str = "pass"

    def run(self, ctx: PassContext) -> Optional[Dict[str, int]]:
        raise NotImplementedError


class PassPipeline:
    """A pass schedule with built-in self-checking.

    ``verify`` policies:

    * ``"each"``      (default) after every pass, run the schedule verifier
                      and the dataflow-equivalence oracle against the
                      original kernel — the paper's translator promise,
                      enforced at pass granularity;
    * ``"schedule"``  schedule verifier only after every pass (cheap);
    * ``"final"``     both checks once, after the last pass;
    * ``"none"``      no checks (callers own verification).
    """

    VERIFY_MODES = ("each", "schedule", "final", "none")

    def __init__(self, passes: Sequence[Pass], verify: str = "each"):
        if verify not in self.VERIFY_MODES:
            raise ValueError(f"unknown verify mode {verify!r}; want one of {self.VERIFY_MODES}")
        self.passes = list(passes)
        self.verify = verify

    def run(
        self,
        ctx: PassContext,
        observer: Optional[Callable[[Pass, PassContext], None]] = None,
    ) -> PassContext:
        PIPELINE_COUNTERS["pipelines"] += 1
        with obs.span(
            "pipeline", kernel=ctx.kernel.name, passes=len(self.passes),
            verify=self.verify,
        ):
            for p in self.passes:
                with obs.span(f"pass:{p.name}"):
                    t0 = time.perf_counter()
                    stats = p.run(ctx) or {}
                    dt = time.perf_counter() - t0
                ctx.passes.append(PassStat(p.name, dt, stats))
                PIPELINE_COUNTERS["passes"] += 1
                if obs.enabled():
                    reg = obs.metrics()
                    reg.counter("pipeline.passes").inc()
                    reg.histogram(f"pass.{p.name}.ms").observe(dt * 1e3)
                    for k, v in stats.items():
                        if isinstance(v, (int, float)) and v:
                            reg.counter(f"pass.{p.name}.{k}").inc(v)
                if self.verify == "each":
                    self.check(ctx, p.name)
                elif self.verify == "schedule":
                    self.check(ctx, p.name, semantics=False)
                if observer is not None:
                    observer(p, ctx)
            if self.verify == "final":
                self.check(ctx, "final")
            if obs.enabled():
                obs.metrics().counter("pipeline.runs").inc()
        return ctx

    @staticmethod
    def check(ctx: PassContext, label: str, semantics: bool = True) -> None:
        """Incremental self-check: re-verify only what changed.

        Barrier scopes whose scheduling signature matches the last proven
        state are skipped (scope verification is content-local); the
        whole-program dataflow oracle is skipped while the kernel's semantic
        signature matches the last proven-equivalent state (e.g. after a
        stall fixup, which edits only control words).
        """
        blocks = _blocks(ctx.kernel)
        sigs = [_sched_signature(b) for b in blocks]
        old = ctx._sched_sigs
        for i, (block, sig) in enumerate(zip(blocks, sigs)):
            if old is not None and i < len(old) and old[i] == sig:
                continue
            errs = verify_block(block, ctx.arch.num_barriers)
            if errs:
                ctx._sched_sigs = None
                raise PassVerificationError(
                    f"{ctx.kernel.name}: schedule violations after pass "
                    f"'{label}': {errs[:3]}"
                )
        ctx._sched_sigs = sigs
        if semantics:
            sem = _sem_signature(ctx.kernel)
            if sem != ctx._sem_verified:
                if not equivalent(ctx.original, ctx.kernel):
                    raise PassVerificationError(
                        f"{ctx.kernel.name}: dataflow mismatch vs original "
                        f"after pass '{label}'"
                    )
                ctx._sem_verified = sem


# ---------------------------------------------------------------------------
# Barrier tracker (Fig. 3, lines 32-53)
# ---------------------------------------------------------------------------


class BarrierTracker:
    """Tracks which instruction last set each scoreboard barrier and the
    stall cycles elapsed since, to hand out the least-costly barrier.

    ``arch`` supplies the barrier count and the residual-latency table
    (``None`` = Maxwell)."""

    def __init__(self, arch=None) -> None:
        if arch is None:
            from repro_torch.arch import get_arch

            arch = get_arch("maxwell")
        self.arch = arch
        self.num_barriers = arch.num_barriers
        self.slots: List[Optional[List]] = [None] * self.num_barriers

    def reset(self) -> None:
        """Barriers cannot span basic blocks (cleared before jumps)."""
        self.slots = [None] * self.num_barriers

    def get_barrier(self, setter: Instr) -> int:
        """Fig. 3 ``GetBarrier``: a free barrier, else the one whose pending
        latency is closest to already-elapsed (minimum residual stall).

        When a busy barrier must be reused, the new setter first *waits* on
        it — this is the "additional stalls" the paper describes, made
        explicit so the schedule verifier and simulator see the true cost.
        """
        for b in range(self.num_barriers):
            if self.slots[b] is None:
                self.slots[b] = [setter, 0]
                return b
        best_b, best_stall = None, self.arch.latency.global_mem + 1
        for b in range(self.num_barriers):
            inst, elapsed = self.slots[b]
            residual = self.arch.residual_latency(inst.info.klass) - elapsed
            if residual < best_stall:
                best_b, best_stall = b, residual
        setter.ctrl.wait.add(best_b)
        self.slots[best_b] = [setter, 0]
        return best_b

    def update(self, inst: Instr) -> None:
        """Fig. 3 ``UpdateBarrierTracker`` (waits cleared before records so
        that a forced reuse in :meth:`get_barrier` stays consistent)."""
        slots = self.slots
        ctrl = inst.ctrl
        for b in ctrl.wait:
            s = slots[b]
            if s is not None and s[0] is not inst:
                slots[b] = None
        if ctrl.read_bar is not None:
            slots[ctrl.read_bar] = [inst, 0]
        if ctrl.write_bar is not None:
            slots[ctrl.write_bar] = [inst, 0]
        stall = ctrl.stall
        for s in slots:
            if s is not None and s[0] is not inst:
                s[1] += stall


# ---------------------------------------------------------------------------
# RDV bank choice (§3.4.1, first strategy)
# ---------------------------------------------------------------------------


def choose_rdv_bank(
    kernel: Kernel,
    candidates: Sequence[Tuple[int, int]],
    wide: bool,
    arch=None,
) -> int:
    """Pick the register bank for RDV minimizing same-instruction conflicts.

    For every instruction that touches a candidate register, count the source
    operands (post-rename survivors) that would share RDV's bank.  Banking
    comes from the architecture (Maxwell: 4 banks, even banks for pairs;
    Volta: 2 banks, pairs pinned to bank 0).
    """
    if arch is None:
        from repro_torch.arch import arch_of

        arch = arch_of(kernel)
    cand_regs = {r for r, _ in candidates}
    banks = arch.rdv_banks(wide)
    scores = {b: 0 for b in banks}
    for ins in kernel.instructions():
        touched = [r for r in ins.leading_regs() if r in cand_regs]
        if not touched:
            continue
        others = [r for r in ins.src_words() if r not in cand_regs and r != RZ]
        for b in banks:
            scores[b] += sum(1 for r in others if arch.reg_bank(r) == b)
    return min(banks, key=lambda b: (scores[b], b))


# ---------------------------------------------------------------------------
# The per-register demotion transform (Fig. 3 main loop body)
# ---------------------------------------------------------------------------


def demote_register(
    k: Kernel,
    r: int,
    width: int,
    offsets: List[int],
    rdv: int,
    rda: int,
    space: SpillSpace,
) -> None:
    """Demote one register: walk the program, rename ``r`` -> RDV, insert
    spill-space loads/stores with tracked barriers.

    The :class:`~repro_torch.core.spillspace.SpillSpace` supplies the opcodes:
    shared space (``LDS``/``STS``, rda=tid*4) realizes RegDem's demotion;
    local space (``LDL``/``STL``, rda=RZ) realizes nvcc-style local-memory
    spilling for the comparison variants (§5.3)."""
    from repro_torch.arch import arch_of

    tracker = BarrierTracker(arch_of(k))
    new_items: List[object] = []
    #: waits to attach to the next real instruction (line 18-19 of Fig. 3)
    pending_next_wait: Set[int] = set()
    #: register word -> unresolved read barrier guarding it (a store still
    #: holds the register as a source operand).  A new writer of the word —
    #: e.g. an inserted demoted load clobbering RDV after a *user* store
    #: whose address register was demoted — must wait on it (WAR).
    pending_read: Dict[int, int] = {}
    prev_real: Optional[Instr] = None

    def append(ins_or_label) -> None:
        nonlocal prev_real
        new_items.append(ins_or_label)
        if isinstance(ins_or_label, Instr):
            nonlocal pending_next_wait
            ins = ins_or_label
            ctrl = ins.ctrl
            if pending_next_wait:
                ctrl.wait |= pending_next_wait
                pending_next_wait = set()
            if pending_read:
                # WAR guard against in-flight store reads
                for rw in ins.dst_words():
                    if rw in pending_read:
                        ctrl.wait.add(pending_read.pop(rw))
                if pending_read and ctrl.wait:
                    waits = ctrl.wait
                    for rw in [
                        r for r, bb in pending_read.items() if bb in waits
                    ]:
                        del pending_read[rw]
            if ctrl.read_bar is not None:
                for rw in ins.src_words():
                    if rw != RZ:
                        pending_read[rw] = ctrl.read_bar
            tracker.update(ins)
            prev_real = ins

    for it in k.items:
        if isinstance(it, Label):
            tracker.reset()
            pending_read.clear()
            new_items.append(it)
            continue
        ins: Instr = it
        if ins.info.is_branch:
            tracker.reset()
            pending_read.clear()
        if r not in ins.leading_regs():
            append(ins)
            continue

        is_dst = r in ins.dsts
        is_src = r in ins.srcs
        ins.rename(r, rdv)

        # ---- read access: LDS RDV, [RDA+offset] before inst (lines 20-29) --
        if is_src:
            for j in range(width):
                lds = Instr(
                    space.load_op,
                    [rdv + j],
                    [rda],
                    offset=offsets[j],
                    pred=ins.pred,
                    pred_neg=ins.pred_neg,
                    tag="demoted_load",
                )
                lds.ctrl.read_bar = tracker.get_barrier(lds)
                lds.ctrl.write_bar = tracker.get_barrier(lds)
                if (
                    prev_real is not None
                    and prev_real.tag == "demoted_store"
                    and prev_real.ctrl.read_bar is not None
                ):
                    # RDV must be free before the demoted register is loaded
                    lds.ctrl.wait.add(prev_real.ctrl.read_bar)
                append(lds)
                if space.unpack_op is not None:
                    # the unpack consumes the loaded value, taking over the
                    # load's barrier waits; the renamed instruction then only
                    # needs the fixed-latency ALU gap fixup_stalls inserts
                    upk = Instr(
                        space.unpack_op,
                        [rdv + j],
                        [rdv + j],
                        pred=ins.pred,
                        pred_neg=ins.pred_neg,
                        tag="demoted_unpack",
                    )
                    upk.ctrl.wait.add(lds.ctrl.read_bar)
                    upk.ctrl.wait.add(lds.ctrl.write_bar)
                    append(upk)
                else:
                    ins.ctrl.wait.add(lds.ctrl.read_bar)
                    ins.ctrl.wait.add(lds.ctrl.write_bar)
        append(ins)

        # ---- write access: STS [RDA+offset], RDV after inst (lines 11-19) --
        if is_dst:
            for j in range(width):
                if ins.info.needs_write_barrier and ins.ctrl.write_bar is None:
                    ins.ctrl.write_bar = tracker.get_barrier(ins)
                if space.pack_op is not None:
                    # the pack consumes the produced value, taking over the
                    # producer's write-barrier wait; the store then only
                    # needs the ALU gap against the pack
                    pck = Instr(
                        space.pack_op,
                        [rdv + j],
                        [rdv + j],
                        pred=ins.pred,
                        pred_neg=ins.pred_neg,
                        tag="demoted_pack",
                    )
                    if ins.ctrl.write_bar is not None:
                        pck.ctrl.wait.add(ins.ctrl.write_bar)
                    append(pck)
                sts = Instr(
                    space.store_op,
                    srcs=[rda, rdv + j],
                    offset=offsets[j],
                    pred=ins.pred,
                    pred_neg=ins.pred_neg,
                    tag="demoted_store",
                )
                if space.pack_op is None and ins.ctrl.write_bar is not None:
                    sts.ctrl.wait.add(ins.ctrl.write_bar)
                sts.ctrl.read_bar = tracker.get_barrier(sts)
                append(sts)
                # the *next* instruction must wait for RDV to be read back out
                # (Fig. 3 lines 18-19) — recorded after append so the store
                # does not wait on its own barrier
                pending_next_wait.add(sts.ctrl.read_bar)

    # drain: if the stream ended with a pending wait, park it on the last
    # real instruction (kernels end in EXIT, so this is the normal path)
    if pending_next_wait and prev_real is not None:
        prev_real.ctrl.wait |= pending_next_wait
    k.items = new_items


# ---------------------------------------------------------------------------
# Rematerialization helpers (the nvcc --maxrregcount model, §5.3)
# ---------------------------------------------------------------------------


def _const_defs(kernel: Kernel) -> Dict[int, float]:
    """Registers defined exactly once, by a ``MOV32I`` (rematerializable)."""
    defs: Dict[int, List[Instr]] = {}
    for ins in kernel.instructions():
        for r in ins.dsts:
            defs.setdefault(r, []).append(ins)
    out: Dict[int, float] = {}
    for r, instrs in defs.items():
        if len(instrs) == 1 and instrs[0].op == "MOV32I" and instrs[0].pred is None:
            out[r] = instrs[0].imm or 0.0
    return out


def _remat_one(kernel: Kernel, r: int, value: float, tmp: int) -> None:
    """Remove ``r``'s constant definition; recompute into ``tmp`` before each
    use ("less efficient instruction sequences", paper §1)."""
    new_items: List[object] = []
    for it in kernel.items:
        if isinstance(it, Label):
            new_items.append(it)
            continue
        ins: Instr = it
        if ins.op == "MOV32I" and ins.dsts == [r]:
            continue  # drop the definition
        if r in ins.srcs:
            mov = Instr(
                "MOV32I",
                [tmp],
                imm=value,
                pred=ins.pred,
                pred_neg=ins.pred_neg,
                tag="remat",
            )
            new_items.append(mov)
            ins.srcs = [tmp if s == r else s for s in ins.srcs]
        new_items.append(ins)
    kernel.items = new_items


# ---------------------------------------------------------------------------
# Concrete passes (the paper's transformation stack)
# ---------------------------------------------------------------------------


class ReserveRegistersPass(Pass):
    """Reserve RDV (+ alias for pair demotion), the optional remat temporary,
    and RDA when the spill space needs a base register — "at least two
    registers must be added" (§3.2)."""

    name = "reserve"

    def __init__(self, bank_tune: bool = False, remat_temp: bool = False):
        self.bank_tune = bank_tune      # §3.4.1 RDV bank choice
        self.remat_temp = remat_temp    # distinct temp for rematerialization

    def run(self, ctx: PassContext) -> Dict[str, int]:
        k = ctx.kernel
        wide = any(w == 2 for _, w in ctx.candidates)
        base = k.reg_count
        if wide and base % 2:
            base += 1  # RDV must be even-numbered for pair demotion (§3.2)
        if self.bank_tune and ctx.options.bank_avoid:
            want_bank = choose_rdv_bank(k, ctx.candidates, wide, ctx.arch)
            rdv = base
            step = 2 if wide else 1
            while ctx.arch.reg_bank(rdv) != want_bank:
                rdv += step
        else:
            rdv = base
        nxt = rdv + (2 if wide else 1)
        if self.remat_temp:
            # one instruction may need both a reloaded spill and a recomputed
            # constant simultaneously
            ctx.rtmp = nxt
            nxt += 1
        if ctx.space.needs_base:
            ctx.rda = nxt
            k.rda = nxt
        else:
            ctx.rda = RZ
        ctx.rdv = rdv
        ctx.wide = wide
        return {"rdv": rdv, "rda": ctx.rda, "wide": int(wide)}


class ProloguePass(Pass):
    """Base-address setup at kernel entry (§3.2: RDA = tid*4 for shared
    space); a no-op for spaces without a base register."""

    name = "prologue"

    def run(self, ctx: PassContext) -> Dict[str, int]:
        return {"inserted": ctx.space.emit_prologue(ctx)}


class RematerializationPass(Pass):
    """nvcc's documented preference: recompute single-def constants instead
    of spilling, trading dynamic instructions for register pressure (§5.3).
    Two rematerialized values in one instruction would need two temps, so
    conflicting candidates are skipped (same rule as demotion conflicts)."""

    name = "rematerialize"

    def run(self, ctx: PassContext) -> Dict[str, int]:
        k = ctx.kernel
        consts = _const_defs(k)
        done = 0
        for r, width in list(ctx.candidates):
            if packed_reg_count(k) <= ctx.floor:
                break
            if width != 1 or r not in consts:
                continue
            if ctx.max_remat is not None and ctx.remat + done >= ctx.max_remat:
                break
            if ctx.conflicts.get(r, set()) & ctx.rematted:
                continue
            _remat_one(k, r, consts[r], ctx.rtmp)
            done += 1
            ctx.rematted.add(r)
            ctx.candidates = [(v, w) for v, w in ctx.candidates if v != r]
        war_added = repair_war(k)
        ctx.remat += done
        return {"rematerialized": done, "war_waits_added": war_added}


class DemotionPass(Pass):
    """The Fig. 3 main loop: demote candidates one at a time until the
    register floor is reached, pruning operand conflicts (§3.1 challenge 2)
    after every demoted register."""

    name = "demote"

    def run(self, ctx: PassContext) -> Dict[str, int]:
        k = ctx.kernel
        regs = words = pruned = 0
        space_full = 0
        while ctx.candidates:
            if packed_reg_count(k) <= ctx.floor:
                break
            if not ctx.space.has_room(ctx, ctx.candidates[0][1]):
                space_full = 1
                break
            r, width = ctx.candidates.pop(0)
            offsets = ctx.space.offsets(ctx, width)
            demote_register(k, r, width, offsets, ctx.rdv, ctx.rda, ctx.space)
            ctx.demoted.append((r, width))
            ctx.demoted_words += width
            ctx.space.account(ctx)
            regs += 1
            words += width
            bad = ctx.conflicts.get(r, set())
            before = len(ctx.candidates)
            ctx.candidates = [(c, w) for c, w in ctx.candidates if c not in bad]
            pruned += before - len(ctx.candidates)
        return {
            "demoted_regs": regs,
            "demoted_words": words,
            "conflicts_pruned": pruned,
            "space_full": space_full,
        }


class RedundancyEliminationPass(Pass):
    """§3.4.2 pass 1: drop provably redundant demoted loads/stores."""

    name = "eliminate_redundant"

    def run(self, ctx: PassContext) -> Dict[str, int]:
        from . import postopt

        return {"removed": postopt.eliminate_redundant(ctx.kernel, ctx.rdv)}


class CompactionPass(Pass):
    """§3.3: pack the register space through the relocation space, then
    re-aim RDV/RDA at their post-compaction homes."""

    name = "compact"

    def __init__(self, bank_avoid: Optional[bool] = None):
        #: None = follow ctx.options.bank_avoid (the §3.4.1 variant)
        self.bank_avoid = bank_avoid

    def run(self, ctx: PassContext) -> Dict[str, int]:
        k = ctx.kernel
        bank = ctx.options.bank_avoid if self.bank_avoid is None else self.bank_avoid
        moves = compact(k, bank_avoid=bank)
        ctx.rdv = moves.get(ctx.rdv, ctx.rdv)
        ctx.rda = k.rda if k.rda is not None else ctx.rda
        return {"moved": len(moves), "reg_count": k.reg_count}


class SubstitutionPass(Pass):
    """§3.4.2 pass 3: give distinct demoted-access spans distinct free
    registers so several demoted values can be in flight simultaneously."""

    name = "substitute"

    def run(self, ctx: PassContext) -> Dict[str, int]:
        from . import postopt

        renamed = postopt.substitute_value_register(
            ctx.kernel, ctx.rdv, ctx.kernel.reg_count
        )
        return {"renamed_spans": renamed}


class ReschedulePass(Pass):
    """§3.4.2 pass 2: hoist demoted loads earlier and relax demoted-store
    read barriers where provably safe."""

    name = "reschedule"

    def run(self, ctx: PassContext) -> Dict[str, int]:
        from . import postopt

        return {"moved": postopt.reschedule(ctx.kernel, ctx.rdv, ctx.rda)}


class StallFixupPass(Pass):
    """Recompute stall counts for the transformed stream, keeping the
    barrier assignments the demotion machinery placed."""

    name = "fixup_stalls"

    def run(self, ctx: PassContext) -> None:
        fixup_stalls(ctx.kernel)


class PoolAnchorPass(Pass):
    """Charge the warp-pool register cost (arXiv 1503.05694) honestly.

    Warp-level resource sharing backs demoted slots with the register file:
    each warp gives up its share of the pool — ``ceil(demoted_words /
    share)`` architectural registers.  The compiler model can't shrink the
    register file, so after compaction this pass anchors the kernel's
    register count at the true post-sharing demand by defining the highest
    pool register with a dead ``MOV`` at kernel entry.  Runs after
    :class:`CompactionPass` (so compaction can't pack the charge away) and
    before :class:`StallFixupPass` (the anchor is an ordinary 1-stall ALU
    op)."""

    name = "pool_anchor"

    def __init__(self, share: int):
        if share < 2:
            raise ValueError(f"warp pool needs share >= 2 warps, got {share}")
        self.share = share

    def run(self, ctx: PassContext) -> Dict[str, int]:
        import math

        if not ctx.demoted_words:
            return {"pool_regs": 0}
        k = ctx.kernel
        pool_regs = math.ceil(ctx.demoted_words / self.share)
        from .isa import Ctrl

        anchor = Instr(
            "MOV",
            [k.reg_count + pool_regs - 1],
            [RZ],
            ctrl=Ctrl(stall=1),
            tag="pool_anchor",
        )
        k.items[:0] = [anchor]
        return {"pool_regs": pool_regs, "reg_count": k.reg_count}


# ---------------------------------------------------------------------------
# Pipeline configurations
# ---------------------------------------------------------------------------


def demotion_pipeline(options: Optional[RegDemOptions] = None, verify: str = "each") -> PassPipeline:
    """RegDem's §3 schedule: prologue → demotion → redundancy elimination →
    compaction → substitution → rescheduling → stall fixup, with the
    optional passes gated by ``options``."""
    options = options or RegDemOptions()
    passes: List[Pass] = [
        ReserveRegistersPass(bank_tune=True),
        ProloguePass(),
        DemotionPass(),
    ]
    if options.elim_redundant:
        passes.append(RedundancyEliminationPass())
    passes.append(CompactionPass())
    if options.substitute:
        passes.append(SubstitutionPass())
    if options.reschedule:
        passes.append(ReschedulePass())
    passes.append(StallFixupPass())
    return PassPipeline(passes, verify=verify)


def aggressive_pipeline(verify: str = "each") -> PassPipeline:
    """The nvcc ``--maxrregcount`` model (§5.3): rematerialize first, spill
    the remainder, compact without bank tuning, fix up stalls."""
    return PassPipeline(
        [
            ReserveRegistersPass(bank_tune=False, remat_temp=True),
            ProloguePass(),
            RematerializationPass(),
            DemotionPass(),
            CompactionPass(bank_avoid=False),
            StallFixupPass(),
        ],
        verify=verify,
    )
