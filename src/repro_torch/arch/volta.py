"""The Volta/Turing backend (CC 7.x), modelled after TuringAs.

Differences from Maxwell that matter to RegDem, each carried by the
descriptor so every layer picks them up through the registry:

* **encoding** — 128-bit instructions with *in-word* control fields
  (stall / yield / wbar / rbar / wait mask at bit 105); no 3-instruction
  control bundles (:class:`repro_torch.binary.archcodec.VoltaCodec`).  The yield
  bit is encoded directly, not inverted;
* **register file** — 2 banks (64-bit wide; ``reg % 2``) instead of
  Maxwell's 4, so RDV bank tuning has fewer choices and wide (pair)
  demotion pins RDV to bank 0;
* **schedulers** — dual-issue removed: four partitions, one instruction
  per partition per cycle; math units are 16/32-lane, so a warp occupies
  its unit for more cycles (lanes table below);
* **latencies** — shorter ALU pipeline (4 cycles), fast FP64 (32 lanes),
  ~19-cycle shared memory, deeper DRAM path;
* **occupancy / shared memory** — unified L1/shared carve-out: up to
  96 KiB of shared memory per block (vs Maxwell's 48 KiB), which widens
  the shared-memory budget demotion can spill into;
* **registers** — the 256-slot encoding ceiling is unchanged (R0..R254
  usable, slot 255 = RZ), but allocation granularity still steps per
  8 registers/thread x 32 threads.

Numbers are a GV100-class model (80 SMs); absolute values are model
approximations — like the Maxwell table, variant *ratios* are the
quantity of interest.
"""

from __future__ import annotations

from repro_torch.binary.archcodec import VOLTA_CODEC
from repro_torch.core.isa import OpClass
from repro_torch.core.occupancy import SMConfig

from .registry import Arch, LatencyModel, register_arch

#: GV100-class per-SM limits.
VOLTA_SM = SMConfig(
    registers=64 * 1024,
    max_threads=2048,
    max_warps=64,
    max_blocks=32,
    smem_bytes=96 * 1024,
    smem_per_block=96 * 1024,  # unified L1/shared carve-out, opt-in per block
    warp_size=32,
    reg_alloc_unit=256,
    smem_alloc_unit=256,
    max_regs_per_thread=255,
    num_sms=80,
)

#: Functional-unit lanes per SM sub-core x 4 partitions (V100: 64 FP32,
#: 64 INT32, 32 FP64, 16 SFU, 32 LSU lanes per SM).
VOLTA_LANES = {
    OpClass.FP32: 64,
    OpClass.INT: 64,
    OpClass.FP64: 32,
    OpClass.SFU: 16,
    OpClass.LSU_GLOBAL: 32,
    OpClass.LSU_SHARED: 32,
    OpClass.LSU_LOCAL: 32,
    OpClass.CONTROL: 64,
    OpClass.MISC: 32,
}

VOLTA_ARCH = register_arch(
    Arch(
        name="volta",
        full_name="NVIDIA Volta/Turing (CC 7.x)",
        chips=("GV100", "TU102", "TU104"),
        sm=VOLTA_SM,
        latency=LatencyModel(
            alu=4,
            control=4,
            misc=15,
            fp64=8,
            sfu=16,
            shared=19,
            local=70,
            global_mem=375,
            read_release=20,
        ),
        lanes=VOLTA_LANES,
        codec=VOLTA_CODEC,
        num_barriers=6,
        num_reg_banks=2,
        num_smem_banks=32,
        schedulers=4,
        dual_issue=False,  # Volta removed dual-issue
        issue_width=4,
        smem_spill_limit=96 * 1024,
        max_regs_per_thread=255,
        aliases=("turing", "sm_70", "sm_75", "gv100", "tu102"),
    )
)
