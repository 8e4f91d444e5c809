"""Maxwell-like abstract GPU ISA.

RegDem (the paper) operates on NVIDIA SASS extracted from .cubin files via
MaxAs.  nvcc/SASS are unavailable here, so the faithful reproduction runs on
an abstract ISA that preserves every property the RegDem algorithm touches:

* 32-bit general registers ``R0..R254`` plus the zero register ``RZ``;
  kernel register usage is charged by the *highest used register number + 1*
  (paper §3, challenge 5);
* multi-word (64-bit) values occupy an *aligned* even/odd register pair and
  create register aliases (challenge 3);
* the Maxwell control word: per-instruction stall count, yield flag, a write
  barrier index, a read barrier index and a 6-bit wait mask over the six
  hardware scoreboard barriers (challenge 4);
* a 4-bank register file (``bank = reg % 4``; same-instruction same-bank
  source operands serialize — challenge 6);
* 32 x 4-byte shared memory banks (challenge 1);
* opcode classes with distinct latencies and per-SM throughputs (used by the
  performance predictor, paper §4 eq. 2).

The module also provides basic-block / CFG construction and a scalar
interpreter used to prove that binary translation preserves dataflow
semantics (the correctness oracle for :mod:`repro_torch.core.regdem`).
"""

from __future__ import annotations

import enum
import math
import re
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

# ---------------------------------------------------------------------------
# Registers
# ---------------------------------------------------------------------------

#: Zero register number (reads as 0, writes are discarded) — SASS ``RZ``.
RZ: int = 255

#: Number of general-purpose register banks on Maxwell.
NUM_REG_BANKS: int = 4

#: Number of 4-byte shared-memory banks.
NUM_SMEM_BANKS: int = 32

#: Number of hardware scoreboard ("instruction") barriers on Maxwell/Pascal.
NUM_BARRIERS: int = 6

#: Stall latencies used by the paper (§3.2): device/global memory and shared
#: memory access latencies in cycles.
GL_MEM_STALL: int = 200
SH_MEM_STALL: int = 24


def reg_bank(reg: int) -> int:
    """Register-file bank of ``reg`` (Maxwell: 4 banks, ``reg % 4``)."""
    return reg % NUM_REG_BANKS


def smem_bank(byte_addr: int) -> int:
    """Shared-memory bank of a byte address (32 banks of 4-byte words)."""
    return (byte_addr // 4) % NUM_SMEM_BANKS


# ---------------------------------------------------------------------------
# Opcode metadata
# ---------------------------------------------------------------------------


class OpClass(enum.Enum):
    """Functional-unit class of an opcode.

    ``throughput`` is instructions/cycle/SM (Maxwell GM200 numbers used by the
    paper: 128 FP32 cores, 4 FP64 cores, 32 LSU lanes, 32 SFU lanes).
    ``latency`` is the producer->consumer latency in cycles.
    """

    FP32 = ("fp32", 128, 6)
    INT = ("int", 128, 6)
    FP64 = ("fp64", 4, 48)
    SFU = ("sfu", 32, 20)
    LSU_GLOBAL = ("lsu_global", 32, GL_MEM_STALL)
    LSU_SHARED = ("lsu_shared", 32, SH_MEM_STALL)
    LSU_LOCAL = ("lsu_local", 32, GL_MEM_STALL)
    CONTROL = ("control", 128, 6)
    MISC = ("misc", 32, 20)

    def __init__(self, tag: str, throughput: int, latency: int):
        self.tag = tag
        self.throughput = throughput
        self.latency = latency


#: Maximum per-SM instruction throughput (FP32 cores) — eq. 2 in the paper.
MAX_THROUGHPUT: int = 128


@dataclass(frozen=True)
class OpInfo:
    """Static description of one opcode."""

    name: str
    klass: OpClass
    #: number of destination registers (before widening for 64-bit ops)
    n_dst: int
    #: number of source register operands
    n_src: int
    #: 32-bit words per register operand (2 => aligned even/odd pair)
    width: int = 1
    is_load: bool = False
    is_store: bool = False
    is_branch: bool = False
    is_exit: bool = False
    #: FLOPs contributed per thread (for roofline-style accounting)
    flops: int = 0

    @property
    def is_memory(self) -> bool:
        return self.is_load or self.is_store

    @property
    def needs_write_barrier(self) -> bool:
        """Variable-latency result => consumer must wait on a write barrier."""
        return self.is_load or self.klass in (OpClass.FP64, OpClass.SFU)

    @property
    def needs_read_barrier(self) -> bool:
        """Stores hold source operands in flight => write-after-read hazard."""
        return self.is_store


def _op(name, klass, n_dst, n_src, **kw) -> Tuple[str, OpInfo]:
    return name, OpInfo(name, klass, n_dst, n_src, **kw)


#: The opcode table.  A compact but representative subset of Maxwell SASS.
OPCODES: Dict[str, OpInfo] = dict(
    [
        # 32-bit floating point
        _op("FADD", OpClass.FP32, 1, 2, flops=1),
        _op("FMUL", OpClass.FP32, 1, 2, flops=1),
        _op("FFMA", OpClass.FP32, 1, 3, flops=2),
        _op("FMNMX", OpClass.FP32, 1, 2, flops=1),
        # integer
        _op("IADD", OpClass.INT, 1, 2),
        _op("ISCADD", OpClass.INT, 1, 2),  # a*imm + b (shift-add)
        _op("XMAD", OpClass.INT, 1, 3),  # 16x16+32 multiply-add
        _op("LOP", OpClass.INT, 1, 2),  # logic op (AND)
        _op("SHL", OpClass.INT, 1, 1),
        _op("SHR", OpClass.INT, 1, 1),
        _op("MOV", OpClass.INT, 1, 1),
        _op("MOV32I", OpClass.INT, 1, 0),
        _op("ISETP", OpClass.INT, 0, 2),  # writes predicate, not a register
        # 64-bit floating point (register pairs)
        _op("DADD", OpClass.FP64, 1, 2, width=2, flops=1),
        _op("DMUL", OpClass.FP64, 1, 2, width=2, flops=1),
        _op("DFMA", OpClass.FP64, 1, 3, width=2, flops=2),
        # special function unit
        _op("MUFU", OpClass.SFU, 1, 1, flops=1),  # rcp/sqrt/exp family
        # memory
        _op("LDG", OpClass.LSU_GLOBAL, 1, 1, is_load=True),
        _op("STG", OpClass.LSU_GLOBAL, 0, 2, is_store=True),
        _op("LDG64", OpClass.LSU_GLOBAL, 1, 1, width=2, is_load=True),
        _op("STG64", OpClass.LSU_GLOBAL, 0, 2, width=2, is_store=True),
        _op("LDS", OpClass.LSU_SHARED, 1, 1, is_load=True),
        _op("STS", OpClass.LSU_SHARED, 0, 2, is_store=True),
        _op("LDL", OpClass.LSU_LOCAL, 1, 1, is_load=True),
        _op("STL", OpClass.LSU_LOCAL, 0, 2, is_store=True),
        # misc / control
        _op("S2R", OpClass.MISC, 1, 0),  # read special register (tid etc.)
        _op("BRA", OpClass.CONTROL, 0, 0, is_branch=True),
        _op("EXIT", OpClass.CONTROL, 0, 0, is_exit=True),
        _op("NOP", OpClass.CONTROL, 0, 0),
        _op("BAR", OpClass.CONTROL, 0, 0),  # __syncthreads
        # warp-level register resource sharing (arXiv 1503.05694): loads and
        # stores against the co-scheduled warps' shared demoted-slot pool.
        # MISC class: near-register-file port, cheaper than the smem path.
        # Appended after the original table so every pre-existing opcode id
        # (container encodings, CRCs) is unchanged.
        _op("LDP", OpClass.MISC, 1, 1, is_load=True),
        _op("STP", OpClass.MISC, 0, 2, is_store=True),
        # compressed spill slots (arXiv 2006.05693): static pack/unpack of a
        # demoted value around its shared-memory slot (ALU for smem bytes)
        _op("PCK", OpClass.INT, 1, 1),
        _op("UPCK", OpClass.INT, 1, 1),
    ]
)


# ---------------------------------------------------------------------------
# Control information (the Maxwell control word)
# ---------------------------------------------------------------------------


@dataclass
class Ctrl:
    """Per-instruction scheduling control (MaxAs-style).

    ``stall``      issue-stall cycles before the next instruction.
    ``yield_flag`` allow the scheduler to switch warps.
    ``write_bar``  barrier index signalled when the result is written.
    ``read_bar``   barrier index signalled when operands have been read.
    ``wait``       set of barrier indices this instruction waits on.
    """

    stall: int = 1
    yield_flag: bool = False
    write_bar: Optional[int] = None
    read_bar: Optional[int] = None
    wait: Set[int] = field(default_factory=set)

    def copy(self) -> "Ctrl":
        return Ctrl(self.stall, self.yield_flag, self.write_bar, self.read_bar, set(self.wait))

    def encode(self) -> str:
        """MaxAs-like control string ``wait:read:write:yield:stall``."""
        wmask = sum(1 << b for b in self.wait)
        rb = "-" if self.read_bar is None else str(self.read_bar)
        wb = "-" if self.write_bar is None else str(self.write_bar)
        y = "Y" if self.yield_flag else "-"
        return f"{wmask:02x}:{rb}:{wb}:{y}:{self.stall:x}"


# ---------------------------------------------------------------------------
# Instructions
# ---------------------------------------------------------------------------


_UID = [0]


def _next_uid() -> int:
    _UID[0] += 1
    return _UID[0]


#: Instr fields whose assignment invalidates the per-instruction operand
#: cache (opcode metadata, register words, bank conflicts).
_OPERAND_FIELDS = frozenset(("op", "dsts", "srcs"))


class _OperandList(list):
    """A list that invalidates its owning Instr's operand cache on mutation.

    ``dsts``/``srcs`` keep full list semantics (``ins.dsts == [r]``,
    ``.append`` in the parser, ...), but in-place mutation after the cache
    has been read cannot leave it stale."""

    __slots__ = ("_owner",)

    def __init__(self, iterable=(), owner=None):
        super().__init__(iterable)
        self._owner = owner


def _invalidating(name):
    base = getattr(list, name)

    def method(self, *args, **kwargs):
        # getattr guard: pickle restores list items before the _owner slot
        owner = getattr(self, "_owner", None)
        if owner is not None:
            object.__setattr__(owner, "_opc", None)
        return base(self, *args, **kwargs)

    method.__name__ = name
    return method


for _m in (
    "__setitem__", "__delitem__", "__iadd__", "__imul__",
    "append", "extend", "insert", "pop", "remove", "clear", "sort", "reverse",
):
    setattr(_OperandList, _m, _invalidating(_m))
del _m


@dataclass
class Instr:
    """One machine instruction.

    ``dsts``/``srcs`` are *leading* register numbers; for ``width == 2``
    opcodes the odd alias ``r+1`` is implicitly used as well (see
    :meth:`dst_words` / :meth:`src_words`).  Memory ops carry an address
    register in ``srcs[0]`` (loads) / ``srcs[0]`` plus value ``srcs[1]``
    (stores) and an immediate byte ``offset``.

    Derived operand metadata (:attr:`info`, :meth:`dst_words`,
    :meth:`src_words`, :meth:`reg_bank_conflicts`) is computed once per
    static instruction and cached; assignment to ``op``/``dsts``/``srcs``
    and in-place mutation of the operand lists (wrapped in
    :class:`_OperandList`) both invalidate the cache.
    """

    op: str
    dsts: List[int] = field(default_factory=list)
    srcs: List[int] = field(default_factory=list)
    imm: Optional[float] = None
    offset: int = 0
    #: branch target label name (BRA)
    target: Optional[str] = None
    #: predicate register index (None = unpredicated); negated if pred_neg
    pred: Optional[int] = None
    pred_neg: bool = False
    #: destination predicate (ISETP)
    pdst: Optional[int] = None
    ctrl: Ctrl = field(default_factory=Ctrl)
    #: trip count metadata for backward branches (set by kernelgen; used by
    #: the timing simulator and the CFG loop analysis)
    trip_count: Optional[int] = None
    #: provenance tag: "orig" | "demoted_load" | "demoted_store" | "remat"
    #: | "spill_load" | "spill_store"
    tag: str = "orig"
    uid: int = field(default_factory=_next_uid)

    # -- operand cache -------------------------------------------------------

    def __setattr__(self, name: str, value) -> None:
        if name in _OPERAND_FIELDS:
            if isinstance(value, list):
                value = _OperandList(value, self)
            object.__setattr__(self, name, value)
            object.__setattr__(self, "_opc", None)
        else:
            object.__setattr__(self, name, value)

    def _operand_cache(self) -> tuple:
        """(info, dst_words, src_words, bank_conflicts), computed lazily."""
        info = OPCODES[self.op]
        dw: List[int] = []
        for r in self.dsts:
            if r == RZ:
                continue
            dw.extend(range(r, r + info.width))
        sw: List[int] = []
        w = info.width
        is_memory = info.is_memory
        for i, r in enumerate(self.srcs):
            if r == RZ:
                continue
            # address operands of wide memory ops are still 32-bit
            if is_memory and i == 0:
                sw.append(r)
            else:
                sw.extend(range(r, r + w))
        banks: Dict[int, Set[int]] = {}
        for r in set(sw):
            banks.setdefault(reg_bank(r), set()).add(r)
        conflicts = sum(len(v) - 1 for v in banks.values())
        # width-map contributions: leading reg -> operand width, with the
        # address operand of memory ops pinned to width 1 (it stays 32-bit
        # even for wide loads/stores)
        went: List[Tuple[int, int]] = []
        for r in self.dsts:
            if r != RZ:
                went.append((r, w))
        for i, r in enumerate(self.srcs):
            if r != RZ:
                went.append((r, 1 if (is_memory and i == 0) else w))
        lead = frozenset(r for r in self.dsts + self.srcs if r != RZ)
        allw = frozenset(dw + sw)
        cache = (info, tuple(dw), tuple(sw), conflicts, tuple(went), lead, allw)
        object.__setattr__(self, "_opc", cache)
        return cache

    # -- static metadata ----------------------------------------------------

    @property
    def info(self) -> OpInfo:
        c = self._opc
        return (c or self._operand_cache())[0]

    @property
    def is_label(self) -> bool:
        return False

    # -- register accessors (alias-aware) ------------------------------------

    def dst_words(self) -> Tuple[int, ...]:
        """All destination register words including 64-bit aliases."""
        c = self._opc
        return (c or self._operand_cache())[1]

    def src_words(self) -> Tuple[int, ...]:
        c = self._opc
        return (c or self._operand_cache())[2]

    def regs(self) -> FrozenSet[int]:
        c = self._opc
        return (c or self._operand_cache())[6]

    def width_entries(self) -> Tuple[Tuple[int, int], ...]:
        """(reg, width) width-map contributions of this instruction."""
        c = self._opc
        return (c or self._operand_cache())[4]

    def leading_regs(self) -> FrozenSet[int]:
        c = self._opc
        return (c or self._operand_cache())[5]

    def uses(self, reg: int) -> bool:
        return reg in self.regs()

    def rename(self, old: int, new: int) -> None:
        """Rename a *leading* register operand everywhere it appears."""
        self.dsts = [new if r == old else r for r in self.dsts]
        self.srcs = [new if r == old else r for r in self.srcs]

    # -- register bank conflicts ---------------------------------------------

    def reg_bank_conflicts(self) -> int:
        """Number of serialized extra cycles from same-bank source operands."""
        c = self._opc
        return (c or self._operand_cache())[3]

    # -- printing -------------------------------------------------------------

    def render(self) -> str:
        parts = []
        if self.pred is not None:
            parts.append(f"@{'!' if self.pred_neg else ''}P{self.pred}")
        ops: List[str] = []
        if self.pdst is not None:
            ops.append(f"P{self.pdst}")
        info = self.info
        for r in self.dsts:
            ops.append(_rname(r))
        if info.is_load:
            ops.append(f"[{_rname(self.srcs[0])}+{self.offset:#x}]")
        elif info.is_store:
            ops.append(f"[{_rname(self.srcs[0])}+{self.offset:#x}]")
            ops.extend(_rname(r) for r in self.srcs[1:])
        else:
            ops.extend(_rname(r) for r in self.srcs)
        if self.imm is not None:
            ops.append(repr(self.imm))
        if self.target is not None:
            ops.append(self.target)
        parts.append(f"{self.op} {', '.join(ops)};")
        return f"/*{self.ctrl.encode()}*/ {' '.join(parts)}"


def _rname(r: int) -> str:
    return "RZ" if r == RZ else f"R{r}"


@dataclass
class Label:
    """Pseudo-instruction: a branch target."""

    name: str
    uid: int = field(default_factory=_next_uid)

    @property
    def is_label(self) -> bool:
        return True

    def render(self) -> str:
        return f"{self.name}:"


Item = object  # Instr | Label


# ---------------------------------------------------------------------------
# Kernel container
# ---------------------------------------------------------------------------


@dataclass
class Kernel:
    """A GPU kernel: an instruction stream plus launch geometry.

    ``shared_size``   statically allocated shared memory bytes (programmer's).
    ``demoted_size``  dynamically allocated bytes appended by RegDem.
    """

    name: str
    items: List[Item] = field(default_factory=list)
    threads_per_block: int = 256
    num_blocks: int = 1024
    shared_size: int = 0
    demoted_size: int = 0
    #: registers holding kernel parameters / thread id at entry (live-in)
    live_in: Set[int] = field(default_factory=set)
    #: registers whose final value is the kernel's observable output
    live_out: Set[int] = field(default_factory=set)
    #: RDA register (demoted base address) once RegDem reserved it
    rda: Optional[int] = None
    #: target architecture, a :mod:`repro_torch.arch` registry name.  Everything
    #: arch-specific (codec, scheduler latencies, occupancy limits, spill
    #: budget) resolves through this tag.
    arch: str = "maxwell"

    # -- basic queries --------------------------------------------------------

    def instructions(self) -> List[Instr]:
        return [it for it in self.items if isinstance(it, Instr)]

    def used_registers(self) -> Set[int]:
        used: Set[int] = set(self.live_in) | set(self.live_out)
        for ins in self.instructions():
            used |= ins.regs()
        used.discard(RZ)
        return used

    @property
    def reg_count(self) -> int:
        """Architectural register usage: highest used register number + 1."""
        used = self.used_registers()
        return (max(used) + 1) if used else 0

    @property
    def total_shared(self) -> int:
        return self.shared_size + self.demoted_size

    def copy(self) -> "Kernel":
        k = Kernel(
            name=self.name,
            items=[],
            threads_per_block=self.threads_per_block,
            num_blocks=self.num_blocks,
            shared_size=self.shared_size,
            demoted_size=self.demoted_size,
            live_in=set(self.live_in),
            live_out=set(self.live_out),
            rda=self.rda,
            arch=self.arch,
        )
        items = k.items
        for it in self.items:
            if isinstance(it, Instr):
                # positional construction (fields in declaration order);
                # dataclasses.replace costs a kwargs dict + field walk per
                # instruction, which dominates copy() on the search hot path
                items.append(
                    Instr(
                        it.op, list(it.dsts), list(it.srcs), it.imm,
                        it.offset, it.target, it.pred, it.pred_neg,
                        it.pdst, it.ctrl.copy(), it.trip_count, it.tag,
                    )
                )
            else:
                items.append(Label(it.name, uid=_next_uid()))
        return k

    def render(self) -> str:
        # the arch tag is printed only off-default so that Maxwell kernels
        # render byte-identically to the pre-registry layout
        arch_tag = "" if self.arch == "maxwell" else f" arch={self.arch}"
        lines = [
            f"// kernel {self.name}  regs={self.reg_count} "
            f"threads/block={self.threads_per_block} smem={self.shared_size}"
            f"+{self.demoted_size}B{arch_tag}"
        ]
        for it in self.items:
            pad = "" if isinstance(it, Label) else "    "
            lines.append(pad + it.render())
        return "\n".join(lines)

    # -- static instruction counts (used by candidate strategies) ------------

    def static_access_counts(self) -> Dict[int, int]:
        counts: Dict[int, int] = {}
        for ins in self.instructions():
            for r in ins.leading_regs():
                counts[r] = counts.get(r, 0) + 1
        return counts


# ---------------------------------------------------------------------------
# SASS-text round trip
# ---------------------------------------------------------------------------

_INS_RE = re.compile(
    r"^/\*(?P<ctrl>[0-9a-f]{2}:[0-5\-]:[0-5\-]:[Y\-]:[0-9a-f])\*/\s*"
    r"(?:@(?P<neg>!)?P(?P<pred>\d)\s+)?(?P<body>.+);$"
)


def parse_ctrl(text: str) -> Ctrl:
    wmask_s, rb, wb, y, stall = text.split(":")
    wmask = int(wmask_s, 16)
    return Ctrl(
        stall=int(stall, 16),
        yield_flag=(y == "Y"),
        write_bar=None if wb == "-" else int(wb),
        read_bar=None if rb == "-" else int(rb),
        wait={b for b in range(NUM_BARRIERS) if wmask & (1 << b)},
    )


def parse_kernel(text: str, **kernel_kwargs) -> Kernel:
    """Parse the output of :meth:`Kernel.render` back into a Kernel.

    This is the pyReDe "disassembler" direction; :meth:`Kernel.render` is the
    assembler direction.  ``render(parse(render(k))) == render(k)`` is tested.
    """
    k = Kernel(name="parsed", **kernel_kwargs)
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("//"):
            if line.startswith("// kernel"):
                toks = line.split()
                k.name = toks[2]
                for tok in toks[3:]:
                    if tok.startswith("arch="):
                        k.arch = tok[len("arch="):]
            continue
        if line.endswith(":") and not line.startswith("/*"):
            k.items.append(Label(line[:-1]))
            continue
        m = _INS_RE.match(line)
        if not m:
            raise ValueError(f"unparseable SASS line: {line!r}")
        ctrl = parse_ctrl(m.group("ctrl"))
        body = m.group("body")
        opname, _, rest = body.partition(" ")
        info = OPCODES[opname]
        ins = Instr(op=opname, ctrl=ctrl)
        if m.group("pred") is not None:
            ins.pred = int(m.group("pred"))
            ins.pred_neg = m.group("neg") == "!"
        toks = [t.strip() for t in rest.split(",")] if rest else []
        toks = [t for t in toks if t]

        def reg_of(tok: str) -> int:
            return RZ if tok == "RZ" else int(tok[1:])

        i = 0
        if toks and toks[0].startswith("P") and info.n_dst == 0 and opname == "ISETP":
            ins.pdst = int(toks[0][1:])
            i = 1
        for _ in range(info.n_dst):
            ins.dsts.append(reg_of(toks[i]))
            i += 1
        if info.is_memory:
            mtok = toks[i]
            i += 1
            mm = re.match(r"\[(R\d+|RZ)\+(0x[0-9a-f]+|\d+)\]", mtok)
            assert mm, mtok
            ins.srcs.append(reg_of(mm.group(1)))
            ins.offset = int(mm.group(2), 0)
        while i < len(toks):
            t = toks[i]
            if t.startswith("R") and (t == "RZ" or t[1:].isdigit()):
                ins.srcs.append(reg_of(t))
            elif t.startswith(".L") or t.startswith("L"):
                ins.target = t
            else:
                ins.imm = float(t)
            i += 1
        k.items.append(ins)
    return k


# ---------------------------------------------------------------------------
# CFG
# ---------------------------------------------------------------------------


@dataclass
class BasicBlock:
    index: int
    label: Optional[str]
    instrs: List[Instr] = field(default_factory=list)
    succs: List[int] = field(default_factory=list)
    preds: List[int] = field(default_factory=list)
    #: loop nesting depth (0 = not in a loop), filled by find_loops
    loop_depth: int = 0


class CFG:
    """Basic blocks + edges for a :class:`Kernel`.

    Blocks split at labels and after branches/exits, exactly the granularity
    the barrier tracker needs ("barriers are cleared before jump instructions,
    and hence can only span basic blocks" — paper §3.2).
    """

    def __init__(self, kernel: Kernel):
        self.kernel = kernel
        self.blocks: List[BasicBlock] = []
        self._build()
        self._find_loops()

    def _build(self) -> None:
        label_block: Dict[str, int] = {}
        cur = BasicBlock(0, None)
        self.blocks = [cur]

        def new_block(label: Optional[str]) -> BasicBlock:
            blk = BasicBlock(len(self.blocks), label)
            self.blocks.append(blk)
            return blk

        for it in self.kernel.items:
            if isinstance(it, Label):
                if cur.instrs or cur.label is not None:
                    nxt = new_block(it.name)
                    cur = nxt
                else:
                    cur.label = it.name
                label_block[it.name] = cur.index
            else:
                cur.instrs.append(it)
                if it.info.is_branch or it.info.is_exit:
                    cur = new_block(None)
        if not self.blocks[-1].instrs and self.blocks[-1].label is None and len(self.blocks) > 1:
            self.blocks.pop()

        # edges
        for i, blk in enumerate(self.blocks):
            last = blk.instrs[-1] if blk.instrs else None
            fallthrough = i + 1 < len(self.blocks)
            if last is not None and last.info.is_exit:
                continue
            if last is not None and last.info.is_branch:
                tgt = label_block.get(last.target)
                if tgt is not None:
                    blk.succs.append(tgt)
                if last.pred is not None and fallthrough:
                    blk.succs.append(i + 1)
            elif fallthrough:
                blk.succs.append(i + 1)
        for blk in self.blocks:
            for s in blk.succs:
                self.blocks[s].preds.append(blk.index)

    def _find_loops(self) -> None:
        """Mark loop bodies via back edges (succ index <= block index)."""
        for blk in self.blocks:
            for s in blk.succs:
                if s <= blk.index:  # back edge -> natural loop [s, blk]
                    for b in self.blocks[s : blk.index + 1]:
                        b.loop_depth += 1

    def block_of(self, ins: Instr) -> Optional[BasicBlock]:
        for blk in self.blocks:
            if any(i.uid == ins.uid for i in blk.instrs):
                return blk
        return None


# ---------------------------------------------------------------------------
# Liveness (per-block, backwards) — used by value-register substitution
# ---------------------------------------------------------------------------


def liveness(kernel: Kernel) -> Dict[int, Tuple[Set[int], Set[int]]]:
    """Per-block (live_in, live_out) register word sets via fixpoint."""
    cfg = CFG(kernel)
    use: Dict[int, Set[int]] = {}
    defs: Dict[int, Set[int]] = {}
    for blk in cfg.blocks:
        u: Set[int] = set()
        d: Set[int] = set()
        for ins in blk.instrs:
            for r in ins.src_words():
                if r not in d:
                    u.add(r)
            d |= set(ins.dst_words())
        use[blk.index] = u
        defs[blk.index] = d

    live_in: Dict[int, Set[int]] = {b.index: set() for b in cfg.blocks}
    live_out: Dict[int, Set[int]] = {b.index: set() for b in cfg.blocks}
    # kernel outputs are live at exit blocks
    exit_blocks = [
        b.index for b in cfg.blocks if any(i.info.is_exit for i in b.instrs)
    ] or [cfg.blocks[-1].index]
    changed = True
    while changed:
        changed = False
        for blk in reversed(cfg.blocks):
            out: Set[int] = set()
            for s in blk.succs:
                out |= live_in[s]
            if blk.index in exit_blocks:
                out |= set(kernel.live_out)
            inn = use[blk.index] | (out - defs[blk.index])
            if out != live_out[blk.index] or inn != live_in[blk.index]:
                live_out[blk.index] = out
                live_in[blk.index] = inn
                changed = True
    return {b.index: (live_in[b.index], live_out[b.index]) for b in cfg.blocks}


# ---------------------------------------------------------------------------
# Scalar interpreter (dataflow-equivalence oracle)
# ---------------------------------------------------------------------------


class Interp:
    """Executes a kernel for ONE representative thread with concrete values.

    Used to verify that translated kernels compute the same ``live_out``
    values and the same global-store stream as the original.  Demoted
    registers live in per-thread shared-memory words (eq. 1 guarantees each
    thread owns a private word per demoted register), so a scalar execution
    is a sound equivalence check for RegDem's transformations.
    """

    MAX_STEPS = 2_000_000

    def __init__(self, kernel: Kernel, tid: int = 0):
        self.k = kernel
        self.tid = tid
        self.regs: Dict[int, float] = {RZ: 0.0}
        self.preds: Dict[int, bool] = {}
        self.smem: Dict[int, float] = {}
        self.lmem: Dict[int, float] = {}
        self.gmem: Dict[int, float] = {}
        #: warp-shared demoted-slot pool (LDP/STP).  Scalar execution models
        #: one thread, whose pool slots are private by construction — the
        #: per-warp sharing is an occupancy/latency property, not a dataflow
        #: one (co-scheduled warps never alias each other's slots).
        self.pmem: Dict[int, float] = {}
        self.stores: List[Tuple[int, float]] = []

    def run(self, inputs: Dict[int, float], gmem: Optional[Dict[int, float]] = None):
        self.regs.update(inputs)
        if gmem:
            self.gmem.update(gmem)
        labels = {
            it.name: i for i, it in enumerate(self.k.items) if isinstance(it, Label)
        }
        pc = 0
        steps = 0
        trip_counters: Dict[int, int] = {}
        while pc < len(self.k.items):
            steps += 1
            if steps > self.MAX_STEPS:
                raise RuntimeError("interpreter step limit exceeded")
            it = self.k.items[pc]
            if isinstance(it, Label):
                pc += 1
                continue
            ins: Instr = it
            if ins.pred is not None:
                pval = self.preds.get(ins.pred, False)
                if ins.pred_neg:
                    pval = not pval
                if not pval:
                    pc += 1
                    continue
            if ins.info.is_exit:
                break
            if ins.info.is_branch:
                tgt = labels[ins.target]
                if ins.trip_count is not None and tgt < pc:
                    # counted loop: honour the metadata trip count so that
                    # kernels without full index arithmetic still terminate.
                    n = trip_counters.get(ins.uid, 0) + 1
                    trip_counters[ins.uid] = n
                    if n < ins.trip_count:
                        pc = tgt
                    else:
                        trip_counters[ins.uid] = 0
                        pc += 1
                else:
                    pc = tgt
                continue
            self._exec(ins)
            pc += 1
        return {r: self.regs.get(r, 0.0) for r in self.k.live_out}

    # -- semantics ------------------------------------------------------------

    def _r(self, r: int) -> float:
        return 0.0 if r == RZ else self.regs.get(r, 0.0)

    def _w(self, r: int, v: float) -> None:
        if r != RZ:
            self.regs[r] = v

    def _r64(self, r: int) -> float:
        return self._r(r)  # value carried in leading word; alias is shadow

    def _w64(self, r: int, v: float) -> None:
        self._w(r, v)
        self._w(r + 1, _alias_marker(v))

    def _exec(self, ins: Instr) -> None:
        op = ins.op
        s = ins.srcs
        imm = ins.imm if ins.imm is not None else 0.0
        if op in ("FADD", "IADD"):
            self._w(ins.dsts[0], self._r(s[0]) + (self._r(s[1]) if len(s) > 1 else imm))
        elif op == "ISCADD":
            self._w(ins.dsts[0], self._r(s[0]) * (2 ** int(imm)) + self._r(s[1]))
        elif op == "FMUL":
            self._w(ins.dsts[0], self._r(s[0]) * (self._r(s[1]) if len(s) > 1 else imm))
        elif op == "FFMA":
            self._w(ins.dsts[0], self._r(s[0]) * self._r(s[1]) + self._r(s[2]))
        elif op == "FMNMX":
            self._w(ins.dsts[0], max(self._r(s[0]), self._r(s[1])))
        elif op == "XMAD":
            self._w(ins.dsts[0], self._r(s[0]) * self._r(s[1]) + self._r(s[2]))
        elif op == "LOP":
            self._w(ins.dsts[0], float(int(self._r(s[0])) & int(self._r(s[1]))))
        elif op == "SHL":
            self._w(ins.dsts[0], self._r(s[0]) * (2 ** int(imm)))
        elif op == "SHR":
            self._w(ins.dsts[0], float(int(self._r(s[0])) >> int(imm)))
        elif op in ("MOV",):
            self._w(ins.dsts[0], self._r(s[0]))
        elif op == "MOV32I":
            self._w(ins.dsts[0], imm)
        elif op == "ISETP":
            self.preds[ins.pdst] = self._r(s[0]) < self._r(s[1])
        elif op in ("DADD", "DMUL", "DFMA"):
            a, b = self._r64(s[0]), self._r64(s[1])
            if op == "DADD":
                v = a + b
            elif op == "DMUL":
                v = a * b
            else:
                v = a * b + self._r64(s[2])
            self._w64(ins.dsts[0], v)
        elif op == "MUFU":
            x = self._r(s[0])
            self._w(ins.dsts[0], 1.0 / x if x not in (0, 0.0) else math.inf)
        elif op in ("LDG", "LDG64"):
            addr = int(self._r(s[0])) + ins.offset
            v = self.gmem.get(addr, float((addr * 2654435761) % 1009) / 1009.0)
            if op == "LDG64":
                self._w64(ins.dsts[0], v)
            else:
                self._w(ins.dsts[0], v)
        elif op in ("STG", "STG64"):
            addr = int(self._r(s[0])) + ins.offset
            v = self._r64(s[1]) if op == "STG64" else self._r(s[1])
            self.gmem[addr] = v
            self.stores.append((addr, v))
        elif op == "LDS":
            self._w(ins.dsts[0], self.smem.get(int(self._r(s[0])) + ins.offset, 0.0))
        elif op == "STS":
            self.smem[int(self._r(s[0])) + ins.offset] = self._r(s[1])
        elif op == "LDL":
            self._w(ins.dsts[0], self.lmem.get(int(self._r(s[0])) + ins.offset, 0.0))
        elif op == "STL":
            self.lmem[int(self._r(s[0])) + ins.offset] = self._r(s[1])
        elif op == "LDP":
            self._w(ins.dsts[0], self.pmem.get(int(self._r(s[0])) + ins.offset, 0.0))
        elif op == "STP":
            self.pmem[int(self._r(s[0])) + ins.offset] = self._r(s[1])
        elif op in ("PCK", "UPCK"):
            # static compression is value-preserving on the modelled float
            # domain: pack/unpack is an ALU-cost identity round-trip
            self._w(ins.dsts[0], self._r(s[0]))
        elif op == "S2R":
            self._w(ins.dsts[0], float(self.tid))
        elif op in ("NOP", "BAR"):
            pass
        else:  # pragma: no cover - defensive
            raise NotImplementedError(op)


def _alias_marker(v: float) -> float:
    """Shadow value stored in the odd word of a 64-bit pair."""
    return -v if v == v else v


def equivalent(a: Kernel, b: Kernel, trials: int = 4, seed: int = 0) -> bool:
    """Dataflow equivalence of two kernels over random inputs."""
    import random

    rng = random.Random(seed)
    for t in range(trials):
        inputs_a = {r: rng.uniform(1.0, 2.0) for r in a.live_in}
        # map by register number: transformations never rename live-ins
        inputs_b = {r: inputs_a.get(r, rng.uniform(1.0, 2.0)) for r in b.live_in}
        ia, ib = Interp(a, tid=t), Interp(b, tid=t)
        out_a = ia.run(dict(inputs_a))
        out_b = ib.run(dict(inputs_b))
        for r in a.live_out:
            va, vb = out_a.get(r), out_b.get(r)
            if va is None or vb is None or not _close(va, vb):
                return False
        if len(ia.stores) != len(ib.stores):
            return False
        for (aa, va), (ab, vb) in zip(ia.stores, ib.stores):
            if aa != ab or not _close(va, vb):
                return False
    return True


def _close(x: float, y: float, tol: float = 1e-9) -> bool:
    if math.isinf(x) or math.isinf(y):
        return x == y
    return abs(x - y) <= tol * max(1.0, abs(x), abs(y))
