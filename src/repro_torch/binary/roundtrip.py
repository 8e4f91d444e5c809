"""Encode/decode self-checks for the binary substrate.

The translator's guarantee is *semantic*: a container emitted by pyReDe must
decode to a kernel that is dataflow-equivalent to what was encoded, carry an
identical schedule, and re-render to the identical SASS text.  This module
is that oracle; :func:`repro_torch.core.translator.translate` calls it on every
container it emits, and the test suite runs it over the whole kernelgen
corpus.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

from repro_torch.core.isa import Kernel, equivalent
from repro_torch.core.sched import verify_schedule

from .container import dumps, loads, loads_many


class RoundTripError(AssertionError):
    """A container failed the encode/decode self-check."""


def roundtrip(kernel: Kernel) -> Kernel:
    """``loads(dumps(kernel))`` — one trip through the container."""
    return loads(dumps(kernel))


def verified_dumps(kernel: Kernel, check_semantics: bool = True) -> bytes:
    """Serialize the kernel and prove the container round trip is faithful;
    returns the verified container bytes.

    Checks, strongest first:

    1. the re-rendered SASS text is byte-identical (control words included),
       so encode/decode is the identity on the observable program;
    2. the decoded kernel re-encodes to the identical container bytes
       (serialization is deterministic and stable);
    3. schedule validity is preserved exactly (same violation list, which is
       empty for anything the translator emits);
    4. optionally, the decoded kernel is dataflow-equivalent on the
       interpreter — the same oracle the translator applies to demotion.
    """
    blob = dumps(kernel)
    _check_against(kernel, blob, check_semantics)
    return blob


def verified_dumps_many(
    kernels: Sequence[Kernel],
    check_semantics: bool = True,
    notes: Optional[Dict[str, bytes]] = None,
) -> bytes:
    """Multi-kernel :func:`verified_dumps`: serialize the batch into one
    container and prove the round trip is faithful for **every** kernel
    (render identity, byte stability, schedule preservation, and optionally
    dataflow equivalence); returns the verified container bytes.

    ``notes`` are attached as ``.note.*`` sections and take part in the
    byte-stability check (re-encoding the decoded kernels with the same
    notes must reproduce the container bit for bit)."""
    klist = list(kernels)
    blob = dumps(klist, notes=notes)
    decoded = loads_many(blob)
    if len(decoded) != len(klist):
        raise RoundTripError(
            f"container holds {len(decoded)} kernels, expected {len(klist)}"
        )
    for kernel, dec in zip(klist, decoded):
        _check_pair(kernel, dec, check_semantics)
    if dumps(decoded, notes=notes) != blob:
        raise RoundTripError("multi-kernel container bytes are not stable")
    return blob


def check_roundtrip(kernel: Kernel, check_semantics: bool = True) -> Kernel:
    """Assert the container round trip is faithful (see
    :func:`verified_dumps`); returns the decoded kernel."""
    blob = dumps(kernel)
    return _check_against(kernel, blob, check_semantics)


def _check_pair(kernel: Kernel, decoded: Kernel, check_semantics: bool) -> None:
    if decoded.render() != kernel.render():
        raise RoundTripError(
            f"{kernel.name}: decode(encode(k)) renders differently:\n"
            f"--- original ---\n{kernel.render()}\n"
            f"--- decoded ---\n{decoded.render()}"
        )
    if verify_schedule(decoded) != verify_schedule(kernel):
        raise RoundTripError(
            f"{kernel.name}: schedule violations changed across round trip"
        )
    if check_semantics and not equivalent(kernel, decoded):
        raise RoundTripError(f"{kernel.name}: decoded kernel is not dataflow-equivalent")


def _check_against(kernel: Kernel, blob: bytes, check_semantics: bool) -> Kernel:
    decoded = loads(blob)
    if decoded.render() != kernel.render():
        raise RoundTripError(
            f"{kernel.name}: decode(encode(k)) renders differently:\n"
            f"--- original ---\n{kernel.render()}\n"
            f"--- decoded ---\n{decoded.render()}"
        )
    if dumps(decoded) != blob:
        raise RoundTripError(f"{kernel.name}: container bytes are not stable")
    if verify_schedule(decoded) != verify_schedule(kernel):
        raise RoundTripError(f"{kernel.name}: schedule violations changed across round trip")
    if check_semantics and not equivalent(kernel, decoded):
        raise RoundTripError(f"{kernel.name}: decoded kernel is not dataflow-equivalent")
    return decoded
