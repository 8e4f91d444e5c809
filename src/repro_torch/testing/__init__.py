"""repro_torch.testing — test-support machinery that ships with the library.

:mod:`repro_torch.testing.faults` is the deterministic fault-injection layer the
chaos suite drives: torn artifact writes, bit-flipped payloads, pool-worker
crashes, injected latency and transient errors.  Production code consults
it through :func:`repro_torch.testing.faults.active`, which is ``None`` unless a
test (or the serve benchmark's fault phase) installed a plan — the
zero-plan fast path is a single global read.
"""

from .faults import FaultError, FaultInjector, FaultPlan, active, install, injected

__all__ = [
    "FaultError",
    "FaultInjector",
    "FaultPlan",
    "active",
    "install",
    "injected",
]
