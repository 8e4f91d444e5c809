"""The RegDem performance predictor, over the port's dry-run records.

Counterpart of ``repro.core.tpu_predictor`` (the file keeps its name so a
reader finds the other side).  The paper's contract: *statically rank code
variants, never run the worst one, tie-break toward more optimizations*.
Here a variant is a (remat x microbatch x mesh) setting of a training step,
its "binary" is the dry-run's record of it
(:mod:`repro_torch.launch.dryrun`: flops, bytes and wire collective bytes per
device), and the stall model is the three-term roofline:

    t(variant) = max(compute, memory, collective)     -- bound model
               + alpha * sum(non-dominant terms)      -- overlap imperfection

``ALPHA`` is the reference's 0.15, calibrated on the reference's TPU
dry-run records; it is not re-fitted for the H100 here.  The constants are
one H100 SXM's public figures (NVIDIA's data sheet,
https://resources.nvidia.com/en-us-tensor-core/nvidia-tensor-core-gpu-datasheet,
and https://www.nvidia.com/en-us/data-center/h100/): 989 TFLOP/s dense bf16,
3.35 TB/s of HBM3, 80 GB of it, and NVLink at 900 GB/s in both directions
together (450 GB/s each way; a ring's wire bytes leave each device in one
direction).  On the card the caller passes ``hbm_bytes =
torch.cuda.get_device_properties(0).total_memory``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

#: H100 SXM per-card constants (see the module docstring)
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
LINK_BW = 450e9
HBM_BYTES = 80 * 10**9

#: imperfect-overlap weight (the reference's; see module docstring)
ALPHA = 0.15


@dataclasses.dataclass(frozen=True)
class VariantCost:
    name: str
    compute_s: float
    memory_s: float
    collective_s: float
    fits_hbm: bool
    #: optimization-option count for the paper's tie-break rule
    n_options: int = 0

    @property
    def terms(self) -> Dict[str, float]:
        return {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }

    @property
    def dominant(self) -> str:
        return max(self.terms, key=self.terms.get)

    @property
    def estimate_s(self) -> float:
        t = self.terms
        dom = max(t.values())
        return dom + ALPHA * (sum(t.values()) - dom)


def cost_from_record(rec: Dict[str, Any], name: Optional[str] = None,
                     hbm_bytes: int = HBM_BYTES, n_options: int = 0) -> VariantCost:
    """Build a VariantCost from a dry-run record."""
    wire = rec["collectives"].get("wire_bytes", rec["collectives"]["total_bytes"])
    mem = rec["memory"]
    used = mem["argument_bytes"] + mem["temp_bytes"] + mem["output_bytes"]
    return VariantCost(
        name=name or f"{rec['arch']}/{rec['shape']}/{rec.get('variant', 'base')}",
        compute_s=rec["flops"] / PEAK_FLOPS,
        memory_s=rec["bytes_accessed"] / HBM_BW,
        collective_s=wire / LINK_BW,
        fits_hbm=used <= hbm_bytes,
        n_options=n_options,
    )


def select(variants: List[VariantCost]) -> Tuple[VariantCost, List[VariantCost]]:
    """Rank variants; infeasible (HBM-overflow) ones are never chosen when a
    feasible variant exists (the paper's worst-case-avoidance property)."""
    if not variants:
        raise ValueError("no variants")
    feasible = [v for v in variants if v.fits_hbm] or list(variants)
    ranked = sorted(feasible, key=lambda v: (v.estimate_s, -v.n_options))
    return ranked[0], sorted(variants, key=lambda v: v.estimate_s)
