"""Spill spaces: where demoted/spilled register words live.

The paper's transformation stack is parameterized over *where* a spilled
word goes.  RegDem demotes to **shared memory** (eq. 1 layout, ``LDS``/
``STS``, a per-thread base register computed in a prologue); the nvcc
``--maxrregcount`` comparison variants spill to off-chip **local memory**
(``LDL``/``STL``, thread-indexed by the hardware, no base register).  Both
also underlie the research alternatives the §5.3 variants model.

:class:`SpillSpace` captures that choice as one object handed to the pass
pipeline (:mod:`repro_torch.core.passes`) instead of the ``load_op``/``store_op``/
``rda`` parameter plumbing that used to thread through the demotion loop:

* :class:`SharedSpace` — RegDem's bank-conflict-free shared-memory layout
  (eq. 1): the r-th demoted word of thread ``t`` lives at
  ``t*4 + s + r*n*4`` (``s`` = static allocation rounded up to word
  alignment, ``n`` = threads/block).  Needs a base register (RDA = tid*4)
  and accounts every spilled word against the 48 KiB Maxwell limit.
* :class:`LocalSpace` — nvcc-style local-memory spill slots at
  ``r*4``; the hardware scales by thread, so no base register and no
  shared-memory accounting.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, List

if TYPE_CHECKING:  # pragma: no cover - import cycle guard (typing only)
    from .passes import PassContext

#: Maxwell per-block shared memory limit (bytes).  Per-arch budgets come
#: from the :mod:`repro_torch.arch` registry (see :func:`spill_limit`).
SMEM_LIMIT = 48 * 1024


def spill_limit(kernel) -> int:
    """The per-block shared-memory budget demotion may spill into, from the
    kernel's architecture (Maxwell 48 KiB, Volta/Turing 96 KiB)."""
    from repro_torch.arch import arch_of

    return arch_of(kernel).smem_spill_limit


def _round4(x: int) -> int:
    return (x + 3) // 4 * 4


class SpillSpace:
    """Where spilled register words live: opcodes, addressing, accounting."""

    #: human-readable space name (diagnostics / pass stats)
    name: str = "abstract"
    #: opcode loading one spilled word back into the value register
    load_op: str = "LD?"
    #: opcode storing the value register out to the spill slot
    store_op: str = "ST?"
    #: whether demoted addressing needs a reserved base register (RDA)
    needs_base: bool = False
    #: opcode packing the value register before each demoted store / after
    #: each demoted load (``None`` = values go to slots verbatim).  Set by
    #: the compressed-slot space (arXiv 2006.05693).
    pack_op: "str | None" = None
    unpack_op: "str | None" = None

    def offsets(self, ctx: "PassContext", width: int) -> List[int]:
        """Byte offsets of the next ``width`` spill slots (the next demoted
        word index is ``ctx.demoted_words``)."""
        raise NotImplementedError

    def emit_prologue(self, ctx: "PassContext") -> int:
        """Emit base-address setup at kernel entry; returns #instructions
        inserted.  Default: the space needs no prologue."""
        return 0

    def has_room(self, ctx: "PassContext", width: int) -> bool:
        """Whether the space can hold ``width`` more demoted words.  The
        demotion loop checks this *before* popping a candidate, so a space
        with a hard capacity (e.g. the cross-block carve pool) stops the
        demotion gracefully instead of raising mid-pipeline."""
        return True

    def account(self, ctx: "PassContext") -> None:
        """Update per-kernel bookkeeping after a register was spilled."""


class SharedSpace(SpillSpace):
    """RegDem's demoted-register space in unused shared memory (eq. 1)."""

    name = "shared"
    load_op = "LDS"
    store_op = "STS"
    needs_base = True

    def __init__(self, check_limit: bool = True):
        #: raise when demotion would exceed the hardware shared-memory limit
        #: (RegDem refuses; the Hayes & Zhang conversion variants historically
        #: did not guard, so the comparison pipeline disables the check)
        self.check_limit = check_limit

    def offsets(self, ctx: "PassContext", width: int) -> List[int]:
        n = ctx.kernel.threads_per_block
        s_up = _round4(ctx.kernel.shared_size)
        return [s_up + (ctx.demoted_words + j) * n * 4 for j in range(width)]

    def emit_prologue(self, ctx: "PassContext") -> int:
        # RDA = tid * 4 (eq. 1 base address), barriers via the tracker
        from .isa import Ctrl, Instr
        from .passes import BarrierTracker

        s2r = Instr("S2R", [ctx.rdv], ctrl=Ctrl(stall=1))
        shl = Instr("SHL", [ctx.rda], [ctx.rdv], imm=2.0, ctrl=Ctrl(stall=1))
        tracker = BarrierTracker(ctx.arch)
        s2r.ctrl.write_bar = tracker.get_barrier(s2r)
        shl.ctrl.wait.add(s2r.ctrl.write_bar)
        ctx.kernel.items[:0] = [s2r, shl]
        return 2

    def account(self, ctx: "PassContext") -> None:
        k = ctx.kernel
        k.demoted_size = ctx.demoted_words * k.threads_per_block * 4
        limit = spill_limit(k)
        if self.check_limit and k.total_shared > limit:
            raise ValueError(
                f"{k.name}: demotion exceeds shared memory limit "
                f"({limit // 1024} KiB on arch {k.arch!r})"
            )


class LocalSpace(SpillSpace):
    """nvcc-style local-memory spill slots (per-thread, hardware-indexed)."""

    name = "local"
    load_op = "LDL"
    store_op = "STL"
    needs_base = False

    def offsets(self, ctx: "PassContext", width: int) -> List[int]:
        return [(ctx.demoted_words + j) * 4 for j in range(width)]


class WarpPoolSpace(SpillSpace):
    """Warp-level register resource sharing (arXiv 1503.05694).

    Demoted words live in a register-file-backed slot pool shared by
    ``share`` co-scheduled warps (``LDP``/``STP``, MISC class — a
    near-register-file port, cheaper than the shared-memory path and with
    zero shared-memory footprint).  The pool is hardware thread-indexed, so
    no base register; the per-warp register cost — each warp's share of the
    pool, ``ceil(demoted_words / share)`` registers — is charged honestly
    by :class:`~repro_torch.core.passes.PoolAnchorPass` after compaction.
    """

    name = "warp_pool"
    load_op = "LDP"
    store_op = "STP"
    needs_base = False

    def __init__(self, share: int = 2):
        if share < 2:
            raise ValueError(f"warp pool needs share >= 2 warps, got {share}")
        #: co-scheduled warps sharing the pool
        self.share = share

    def offsets(self, ctx: "PassContext", width: int) -> List[int]:
        return [(ctx.demoted_words + j) * 4 for j in range(width)]


class CarveSpace(SharedSpace):
    """Scratchpad sharing across thread blocks (arXiv 1607.03238).

    Demotion slots are carved from the *per-SM* scratchpad pool left unused
    by resident blocks' allocations, instead of this block's own budget —
    same eq.-1 layout and ``LDS``/``STS`` access path as
    :class:`SharedSpace`, but ``demoted_size`` stays zero (nothing is
    charged against this block's allocation, so the occupancy calculator
    sees no shared-memory growth).  Feasibility is a per-SM budget instead:
    every resident block needs its carve alongside every block's static
    allocation, checked in :meth:`has_room` so the demotion loop stops
    gracefully when the SM pool is exhausted.
    """

    name = "carve"

    def __init__(self):
        super().__init__(check_limit=False)

    def _carve_budget(self, ctx: "PassContext", extra_words: int) -> bool:
        from repro_torch.arch import arch_of

        from .occupancy import _ceil_to, occupancy

        k = ctx.kernel
        sm = arch_of(k).sm
        carve = (ctx.demoted_words + extra_words) * k.threads_per_block * 4
        # resident blocks at the demotion target: the whole point is the
        # post-demotion occupancy, so the carve must fit at that block count
        occ = occupancy(max(ctx.floor, 32), k.threads_per_block, k.shared_size, sm)
        static = _ceil_to(k.shared_size, sm.smem_alloc_unit) if k.shared_size else 0
        return occ.resident_blocks * (static + carve) <= sm.smem_bytes

    def has_room(self, ctx: "PassContext", width: int) -> bool:
        return self._carve_budget(ctx, width)

    def account(self, ctx: "PassContext") -> None:
        # nothing lands in this block's own allocation; the per-SM pool
        # budget was enforced by has_room before the demotion ran
        pass


class CompressedSpace(SharedSpace):
    """Compressed spill slots (arXiv 2006.05693).

    Demoted values are packed by static compression to 2-byte slots —
    half the eq.-1 shared-memory footprint — at the cost of one ALU
    ``PCK`` before every demoted store and one ``UPCK`` after every
    demoted load.  Only width-1 registers are compressible (pairs keep
    full-precision lanes), which the strategy's candidate filter enforces.
    """

    name = "compressed"
    pack_op = "PCK"
    unpack_op = "UPCK"

    #: bytes per compressed slot (vs 4 for a full word)
    SLOT_BYTES = 2

    def offsets(self, ctx: "PassContext", width: int) -> List[int]:
        n = ctx.kernel.threads_per_block
        s_up = _round4(ctx.kernel.shared_size)
        return [
            s_up + (ctx.demoted_words + j) * n * self.SLOT_BYTES
            for j in range(width)
        ]

    def emit_prologue(self, ctx: "PassContext") -> int:
        # RDA = tid * SLOT_BYTES: the eq.-1 base scaled to compressed slots
        from .isa import Ctrl, Instr
        from .passes import BarrierTracker

        s2r = Instr("S2R", [ctx.rdv], ctrl=Ctrl(stall=1))
        shl = Instr("SHL", [ctx.rda], [ctx.rdv], imm=1.0, ctrl=Ctrl(stall=1))
        tracker = BarrierTracker(ctx.arch)
        s2r.ctrl.write_bar = tracker.get_barrier(s2r)
        shl.ctrl.wait.add(s2r.ctrl.write_bar)
        ctx.kernel.items[:0] = [s2r, shl]
        return 2

    def account(self, ctx: "PassContext") -> None:
        k = ctx.kernel
        k.demoted_size = ctx.demoted_words * k.threads_per_block * self.SLOT_BYTES
        limit = spill_limit(k)
        if self.check_limit and k.total_shared > limit:
            raise ValueError(
                f"{k.name}: compressed demotion exceeds shared memory limit "
                f"({limit // 1024} KiB on arch {k.arch!r})"
            )


def spill_space(name: str, **kwargs) -> SpillSpace:
    """Look up a spill space by name; keyword arguments are forwarded to the
    space constructor (e.g. ``spill_space("shared", check_limit=False)``)."""
    spaces = {
        "shared": SharedSpace,
        "local": LocalSpace,
        "warp_pool": WarpPoolSpace,
        "carve": CarveSpace,
        "compressed": CompressedSpace,
    }
    if name not in spaces:
        raise ValueError(
            f"unknown spill space {name!r}; want one of {sorted(spaces)}"
        )
    return spaces[name](**kwargs)
