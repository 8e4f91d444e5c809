"""Core: the paper's contribution (RegDem + predictor + pyReDe translator).

The port's own copy of the reference package's ``core`` (numpy, the standard
library and one C file; no framework), plus the framework-level layer.

Faithful-reproduction layer:

* :mod:`repro_torch.core.isa`         Maxwell-like abstract ISA + interpreter
* :mod:`repro_torch.core.occupancy`   CC 5.2 occupancy calculator
* :mod:`repro_torch.core.sched`       control-word scheduler / verifier
* :mod:`repro_torch.core.kernelgen`   synthetic "nvcc" + Table-1 benchmark corpus
* :mod:`repro_torch.core.candidates`  §3.4.3 candidate orderings
* :mod:`repro_torch.core.strategies`  pluggable spill-strategy registry (the
                                 paper's orderings + related-work families)
* :mod:`repro_torch.core.spillspace`  where spilled words live (shared vs local)
* :mod:`repro_torch.core.passes`      the unified spill-transform pass pipeline
* :mod:`repro_torch.core.regdem`      §3 demotion algorithm (Fig. 3), as a
                                 pipeline configuration
* :mod:`repro_torch.core.compaction`  §3.3 relocation space (Fig. 4)
* :mod:`repro_torch.core.postopt`     §3.4 post-spilling optimizations
* :mod:`repro_torch.core.variants`    §5.3 comparison variants (Table 3), same
                                 pipeline, different configurations
* :mod:`repro_torch.core.simulator`   cycle-approximate Maxwell timing model
                                 (two-stage: trace compiler + event-driven
                                 issue loop, cycle-exact vs the reference)
* :mod:`repro_torch.core.simcache`    content-addressed sim/analysis cache
* :mod:`repro_torch.core.predictor`   §4 compile-time performance predictor
* :mod:`repro_torch.core.search`      predictor-guided parallel autotuning search
                                 over the widened variant space
* :mod:`repro_torch.core.translator`  pyReDe driver: batch, cached, multi-kernel
                                 binary-translation service

Architecture registry (see README.md "Architectures"):

* :mod:`repro_torch.arch`  per-arch descriptors (SMConfig, codec, latencies,
                     banking) resolved from each kernel's ``arch`` tag;
                     ships Maxwell/Pascal and Volta/Turing backends

Binary substrate (the pseudo-cubin layer the translator runs on; see
README.md "Binary container format"):

* :mod:`repro_torch.binary.ctrlwords`  21-bit Maxwell control-word packing
* :mod:`repro_torch.binary.archcodec`  per-arch text codecs (Maxwell bundles,
                                 Volta/Turing in-word control fields)
* :mod:`repro_torch.binary.encoding`   fixed-width instruction records
* :mod:`repro_torch.binary.container`  pseudo-cubin ``dumps``/``loads`` (v3:
                                 per-kernel arch tag)
* :mod:`repro_torch.binary.overlay`    SASSOverlay-style annotated disassembly
* :mod:`repro_torch.binary.roundtrip`  encode/decode self-check oracle

Framework-level layer (not imported here: it reads the model configs):

* :mod:`repro_torch.core.vmem_demotion`  where a kernel's loop-carried state
                                         lives (registers / shared memory /
                                         HBM / recompute) on the H100
* :mod:`repro_torch.core.tpu_predictor`  which program variant ships
"""

from .isa import Instr, Kernel, Label, equivalent, parse_kernel
from .occupancy import MAXWELL, Occupancy, occupancy, occupancy_of, spill_targets
from .passes import (
    Pass,
    PassContext,
    PassPipeline,
    PassStat,
    PassVerificationError,
    aggressive_pipeline,
    demotion_pipeline,
    stats_by_pass,
)
from .regdem import RegDemOptions, RegDemResult, auto_targets, demote
from .search import (
    SearchConfig,
    SearchOutcome,
    SearchReport,
    ScoredVariant,
    search,
)
from .simcache import DEFAULT_SIM_CACHE, SimCache, simulate_cached
from .simulator import SimResult, simulate, simulate_reference, speedup
from .spillspace import LocalSpace, SharedSpace, SpillSpace
from .strategies import (
    Strategy,
    StrategyHints,
    get_strategy,
    register_strategy,
    strategy_names,
)
from .translator import (
    BatchTranslationReport,
    TranslationCache,
    TranslationReport,
    TranslationService,
    translate,
    translate_binary,
)

__all__ = [
    "Instr",
    "Kernel",
    "Label",
    "equivalent",
    "parse_kernel",
    "MAXWELL",
    "Occupancy",
    "occupancy",
    "occupancy_of",
    "spill_targets",
    "Pass",
    "PassContext",
    "PassPipeline",
    "PassStat",
    "PassVerificationError",
    "aggressive_pipeline",
    "demotion_pipeline",
    "stats_by_pass",
    "LocalSpace",
    "SharedSpace",
    "SpillSpace",
    "Strategy",
    "StrategyHints",
    "get_strategy",
    "register_strategy",
    "strategy_names",
    "RegDemOptions",
    "RegDemResult",
    "auto_targets",
    "demote",
    "SearchConfig",
    "SearchOutcome",
    "SearchReport",
    "ScoredVariant",
    "search",
    "DEFAULT_SIM_CACHE",
    "SimCache",
    "simulate_cached",
    "SimResult",
    "simulate",
    "simulate_reference",
    "speedup",
    "BatchTranslationReport",
    "TranslationCache",
    "TranslationReport",
    "TranslationService",
    "translate",
    "translate_binary",
]
