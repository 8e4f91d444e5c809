"""Synthetic "nvcc": generates schedule-optimized kernels for the ISA.

The paper evaluates RegDem on nine benchmark kernels (Table 1/2).  nvcc and
the original CUDA sources cannot run here, so this module generates SASS-like
stand-ins whose *register-pressure-relevant* profile matches Table 1 exactly:
register count, threads/block, blocks, static shared memory, and the
dominant instruction mix (FP64 for ``md``, tree-traversal loads for the FSM
suite, streaming global traffic for ``cfd``/``qtc``, ALU-heavy hashing for
``md5hash``...).

The generated kernels are *real programs* over the abstract ISA: they
execute on :class:`repro_torch.core.isa.Interp` (so binary translation can be
verified semantics-preserving) and on the timing simulator (so variants can
be graded), and they are scheduled by :func:`repro_torch.core.sched.schedule` the
way ptxas would schedule them.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Dict, List

from .isa import Instr, Kernel, Label
from .sched import schedule

# Fixed low registers (the "ABI"):
R_TID = 0       # thread id (S2R)
R_IN = 1        # input base pointer (live-in)
R_OUT = 2       # output base pointer (live-in)
R_CNT = 3       # loop counter
R_LIM = 4       # loop limit
R_ADDR = 5      # streaming address
N_FIXED = 6


@dataclass
class Profile:
    """Generation profile for one benchmark kernel (Table 1 row)."""

    name: str
    target_regs: int              # Table 1 "# Registers Used (orig)"
    threads_per_block: int
    num_blocks: int
    shared_size: int              # static shared memory bytes
    regdem_target: int            # Table 1 "target" register count
    nvcc_spills: int              # Table 1 "# Registers Spilled (nvcc)"
    loop_trips: int = 10
    #: number of rematerializable constant registers (MOV32I pool)
    n_consts: int = 8
    #: temporaries for streaming loads etc.
    n_temps: int = 6
    #: fraction of state registers that are FP64 pairs (md == 1.0)
    fp64_frac: float = 0.0
    #: streaming global loads per loop iteration
    loads_per_iter: int = 2
    #: dependent (pointer-chasing) global loads per iteration: each load's
    #: address derives from the previous load's value.  Kills per-warp MLP,
    #: so occupancy directly buys memory parallelism — the regime where the
    #: paper's benchmarks (tree traversals, unstructured grids) live.
    chase_loads: int = 0
    #: global stores per loop iteration (streaming output)
    stores_per_iter: int = 0
    #: user shared-memory ops per loop iteration (tree traversal caches)
    smem_ops_per_iter: int = 0
    #: SFU ops per loop iteration (rsqrt / exp flavour)
    sfu_per_iter: int = 0
    #: use predicated ops in the body (divergence flavour)
    predicated: bool = False
    seed: int = 0

    @property
    def n_state(self) -> int:
        n = self.target_regs - N_FIXED - self.n_consts - self.n_temps
        if n <= 1:
            raise ValueError(f"profile {self.name}: register budget too small")
        if self.fp64_frac > 0 and n % 2:
            n -= 1  # keep pair alignment
        return n


#: Table 1 of the paper, transcribed.  (threads/block, #blocks, smem bytes,
#: orig regs, target regs, nvcc spill count at the target.)
PAPER_BENCHMARKS: Dict[str, Profile] = {
    p.name: p
    for p in [
        Profile("cfd", 68, 192, 1008, 0, 56, 10, loop_trips=12,
                n_consts=10, n_temps=8, loads_per_iter=4, chase_loads=2,
                stores_per_iter=1, sfu_per_iter=1, seed=1),
        Profile("qtc", 55, 64, 1538, 512, 48, 8, loop_trips=16,
                n_consts=8, n_temps=6, loads_per_iter=2, chase_loads=3,
                smem_ops_per_iter=2, predicated=True, seed=2),
        Profile("md5hash", 33, 256, 93790, 0, 32, 0, loop_trips=16,
                n_consts=6, n_temps=4, loads_per_iter=0, sfu_per_iter=0,
                seed=3),
        Profile("md", 34, 256, 228, 0, 32, 1, loop_trips=12,
                n_consts=6, n_temps=6, fp64_frac=1.0, loads_per_iter=2,
                sfu_per_iter=1, seed=4),
        Profile("gaussian", 43, 64, 500, 0, 40, 1, loop_trips=10,
                n_consts=8, n_temps=6, loads_per_iter=2, chase_loads=2,
                stores_per_iter=1, seed=5),
        Profile("conv", 35, 128, 16384, 0, 32, 0, loop_trips=9,
                n_consts=8, n_temps=4, loads_per_iter=2, stores_per_iter=1,
                seed=6),
        Profile("nn", 35, 192, 1024, 1556, 32, 0, loop_trips=14,
                n_consts=6, n_temps=5, loads_per_iter=2, chase_loads=3,
                smem_ops_per_iter=2, predicated=True, seed=7),
        Profile("pc", 36, 256, 1024, 2079, 32, 2, loop_trips=14,
                n_consts=6, n_temps=5, loads_per_iter=2, chase_loads=2,
                smem_ops_per_iter=2, predicated=True, seed=8),
        Profile("vp", 34, 256, 2048, 2079, 32, 0, loop_trips=14,
                n_consts=6, n_temps=4, loads_per_iter=2, chase_loads=3,
                smem_ops_per_iter=2, predicated=True, seed=9),
    ]
}


def generate(profile: Profile) -> Kernel:
    """Generate + schedule one kernel for ``profile``."""
    rng = random.Random(profile.seed)
    k = Kernel(
        name=profile.name,
        threads_per_block=profile.threads_per_block,
        num_blocks=profile.num_blocks,
        shared_size=profile.shared_size,
        live_in={R_IN, R_OUT},
    )
    items: List[object] = k.items
    n_state = profile.n_state
    consts = list(range(N_FIXED, N_FIXED + profile.n_consts))
    state0 = N_FIXED + profile.n_consts
    if profile.fp64_frac > 0 and state0 % 2:
        state0 += 1  # alignment for double pairs
    n_fp64_words = int(n_state * profile.fp64_frac) // 2 * 2
    fp64_pairs = [state0 + 2 * i for i in range(n_fp64_words // 2)]
    fp32_state = list(range(state0 + n_fp64_words, state0 + n_state))
    temps = list(range(state0 + n_state, state0 + n_state + profile.n_temps))

    def emit(op, dsts=(), srcs=(), **kw):
        items.append(Instr(op, list(dsts), list(srcs), **kw))

    # ---- prologue -----------------------------------------------------------
    emit("S2R", [R_TID])
    emit("MOV32I", [R_CNT], imm=0.0)
    emit("MOV32I", [R_LIM], imm=float(profile.loop_trips))
    emit("ISCADD", [R_ADDR], [R_TID, R_IN], imm=2.0)  # addr = tid*4 + in
    for i, c in enumerate(consts):
        emit("MOV32I", [c], imm=round(0.5 + 0.25 * i, 4))
    for i, t in enumerate(temps):
        emit("MOV32I", [t], imm=float(i))
    # initial state loads from global memory
    for i, r in enumerate(fp32_state):
        emit("LDG", [r], [R_ADDR], offset=4 * i)
    for i, r in enumerate(fp64_pairs):
        emit("LDG64", [r], [R_ADDR], offset=4 * len(fp32_state) + 8 * i)

    # ---- main loop ----------------------------------------------------------
    items.append(Label("LOOP"))
    body_rng = rng

    def some_const() -> int:
        return body_rng.choice(consts)

    # streaming loads into temps
    for j in range(profile.loads_per_iter):
        t = temps[j % len(temps)]
        emit("LDG", [t], [R_ADDR], offset=0x100 + 4 * j)
    # dependent load chain (tree traversal / unstructured-grid indirection)
    if profile.chase_loads:
        c0 = temps[0]
        emit("LDG", [c0], [R_ADDR], offset=0x300)
        prev = c0
        for j in range(1, profile.chase_loads):
            t = temps[j % len(temps)]
            emit("LDG", [t], [prev], offset=0x10 * j)
            prev = t
        tgt0 = fp32_state[0] if fp32_state else temps[-1]
        emit("FADD", [tgt0], [tgt0, prev])
    # predicate for divergence-flavoured profiles
    if profile.predicated:
        emit("ISETP", srcs=[temps[0] if temps else consts[0], some_const()], pdst=0)
    # state updates: i-th state register gets 1 + (i % 3) uses
    for i, r in enumerate(fp32_state):
        uses = 1 + (i % 3)
        for u in range(uses):
            other = fp32_state[(i + u + 1) % len(fp32_state)]
            pred = 0 if (profile.predicated and (i + u) % 4 == 0) else None
            emit("FFMA", [r], [r, some_const(), other], pred=pred)
    for i, r in enumerate(fp64_pairs):
        other = fp64_pairs[(i + 1) % len(fp64_pairs)]
        emit("DFMA", [r], [r, other, r])
        if i % 2 == 0:
            emit("DADD", [r], [r, other])
    # fold streamed values into state
    for j in range(profile.loads_per_iter):
        t = temps[j % len(temps)]
        tgt = fp32_state[j % len(fp32_state)] if fp32_state else fp64_pairs[0]
        if fp32_state:
            emit("FFMA", [tgt], [t, some_const(), tgt])
        else:
            emit("FADD", [temps[-1]], [t, temps[-1]])
    # user shared memory traffic (tree-traversal caches): stays inside the
    # programmer's static allocation [0, shared_size).  A profile with no
    # static allocation gets no user smem ops — emitting them at offset 0
    # would write *outside* the declared region, exactly where RegDem's
    # demoted-register slots start (eq. 1 puts them at the end of the
    # static allocation), silently corrupting any demoted value.
    smem_ops = profile.smem_ops_per_iter if profile.shared_size >= 4 else 0
    for j in range(smem_ops):
        t = temps[(j + 1) % len(temps)]
        off = (4 * j * 32) % profile.shared_size
        if j % 2 == 0:
            emit("STS", srcs=[R_TID, fp32_state[j % len(fp32_state)] if fp32_state else temps[0]], offset=off)
        else:
            emit("LDS", [t], [R_TID], offset=off)
            tgt = fp32_state[(j * 5) % len(fp32_state)] if fp32_state else temps[0]
            emit("FADD", [tgt], [tgt, t])
    # SFU flavour
    for j in range(profile.sfu_per_iter):
        src = fp32_state[(3 * j) % len(fp32_state)] if fp32_state else fp64_pairs[0]
        emit("MUFU", [temps[(j + 2) % len(temps)]], [src])
    # streaming stores
    for j in range(profile.stores_per_iter):
        v = fp32_state[(7 * j) % len(fp32_state)] if fp32_state else temps[0]
        emit("STG", srcs=[R_ADDR, v], offset=0x200 + 4 * j)
    # loop bookkeeping
    emit("IADD", [R_ADDR], [R_ADDR], imm=float(4 * profile.loads_per_iter))
    emit("IADD", [R_CNT], [R_CNT], imm=1.0)
    emit("ISETP", srcs=[R_CNT, R_LIM], pdst=1)
    items.append(
        Instr("BRA", target="LOOP", pred=1, trip_count=profile.loop_trips)
    )

    # ---- epilogue: reduce state, store outputs ------------------------------
    if fp32_state:
        acc = temps[0]
        emit("MOV", [acc], [fp32_state[0]])
        for r in fp32_state[1:]:
            emit("FADD", [acc], [acc, r])
        emit("STG", srcs=[R_OUT, acc], offset=0x0)
    if fp64_pairs:
        dacc = fp64_pairs[0]
        for r in fp64_pairs[1:]:
            emit("DADD", [dacc], [dacc, r])
        emit("STG64", srcs=[R_OUT, dacc], offset=0x10)
    emit("EXIT")

    schedule(k)
    assert k.reg_count <= profile.target_regs + 2, (
        f"{profile.name}: generated {k.reg_count} regs, wanted {profile.target_regs}"
    )
    return k


def paper_kernel(name: str) -> Kernel:
    """One of the nine Table-1 stand-ins."""
    return generate(PAPER_BENCHMARKS[name])


def all_paper_kernels() -> Dict[str, Kernel]:
    return {name: generate(p) for name, p in PAPER_BENCHMARKS.items()}


def random_profile(seed: int) -> Profile:
    """A random profile for property-based testing."""
    rng = random.Random(seed)
    target = rng.randint(34, 90)
    n_consts = rng.randint(4, 10)
    n_temps = rng.randint(3, 8)
    # keep the state width positive
    while target - N_FIXED - n_consts - n_temps < 4:
        target += 4
    return Profile(
        name=f"rand{seed}",
        target_regs=target,
        threads_per_block=rng.choice([64, 128, 192, 256]),
        num_blocks=rng.choice([128, 1024, 4096]),
        shared_size=rng.choice([0, 0, 512, 2048]),
        regdem_target=max(32, target - rng.randint(2, 16)),
        nvcc_spills=rng.randint(0, 4),
        loop_trips=rng.randint(3, 12),
        n_consts=n_consts,
        n_temps=n_temps,
        fp64_frac=rng.choice([0.0, 0.0, 0.0, 0.5]),
        loads_per_iter=rng.randint(0, 4),
        stores_per_iter=rng.randint(0, 2),
        smem_ops_per_iter=rng.randint(0, 2) if rng.random() < 0.5 else 0,
        sfu_per_iter=rng.randint(0, 2),
        predicated=rng.random() < 0.4,
        seed=seed,
    )
