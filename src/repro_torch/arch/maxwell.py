"""The Maxwell/Pascal backend — the paper's target architecture.

Numbers are the GM200 (GTX Titan X) model the rest of the repo has always
used; this module only *names* them.  The descriptor's values are pinned by
the pre-registry golden tests (Table-3 demotion counts,
``tests/golden/sim_cycles.json``, container golden bytes): the Maxwell path
through every parameterized layer must stay byte- and cycle-identical.

Model notes:

* four warp schedulers, dual-issue capable; the simulator models an SM
  issue width of 4 (single-issue per scheduler), the historical engine
  value the golden cycle counts pin;
* 21-bit control words bundled 3-per-64-bit ahead of their instructions
  (:class:`repro_torch.binary.archcodec.MaxwellCodec`);
* 4 register banks (``reg % 4``), 6 scoreboard barriers;
* 48 KiB per-block shared memory, of which demotion may use whatever the
  kernel's static allocation leaves free.
"""

from __future__ import annotations

from repro_torch.binary.archcodec import MAXWELL_CODEC
from repro_torch.core.isa import OpClass
from repro_torch.core.occupancy import MAXWELL as MAXWELL_SM

from .registry import Arch, LatencyModel, register_arch

#: Functional-unit lanes per SM (GM200: 128 FP32 cores, 4 FP64, 32 LSU,
#: 32 SFU) — identical to the throughputs baked into :class:`OpClass`.
MAXWELL_LANES = {
    OpClass.FP32: 128,
    OpClass.INT: 128,
    OpClass.FP64: 4,
    OpClass.SFU: 32,
    OpClass.LSU_GLOBAL: 32,
    OpClass.LSU_SHARED: 32,
    OpClass.LSU_LOCAL: 32,
    OpClass.CONTROL: 128,
    OpClass.MISC: 32,
}

MAXWELL_ARCH = register_arch(
    Arch(
        name="maxwell",
        full_name="NVIDIA Maxwell/Pascal (CC 5.x/6.x)",
        chips=("GM200", "GM204", "GP102"),
        sm=MAXWELL_SM,
        latency=LatencyModel(
            alu=6,
            control=6,
            misc=20,
            fp64=48,
            sfu=20,
            shared=24,
            # local-memory traffic is L1-cached: effective latency between
            # shared (24) and DRAM (200) — the paper's premise ordering
            local=80,
            global_mem=200,
            read_release=20,
        ),
        lanes=MAXWELL_LANES,
        codec=MAXWELL_CODEC,
        num_barriers=6,
        num_reg_banks=4,
        num_smem_banks=32,
        schedulers=4,
        dual_issue=True,
        issue_width=4,
        smem_spill_limit=48 * 1024,
        max_regs_per_thread=255,
        aliases=("pascal", "sm_50", "sm_52", "sm_60", "sm_61", "gm200"),
    )
)
