"""Builds the CUDA sources under ``csrc/`` into one shared library, lazily.

The pattern of the reference package's native simulator engine, for ``nvcc``:
the library's file name carries the sha256 of its sources and flags, so a
changed source never meets a stale build; it is compiled at first use, into
``build/repro_torch/`` under the repository root (``REPRO_TORCH_BUILD_DIR``
overrides the directory), and loaded with ``ctypes``.  The sources have a
plain C interface and include no PyTorch header, so a build takes seconds.

Importing this module builds nothing and needs no ``nvcc``.  A failed build
raises :class:`CompileError` with the compiler's output; nothing falls back.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"

#: ``-Xptxas -v`` makes ptxas print each kernel's registers, spills and shared
#: memory; the log is kept beside the library
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


class CompileError(RuntimeError):
    """``nvcc`` is missing or refused a source."""


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    path: Path              # the shared library
    log_path: Path          # nvcc / ptxas output of the build that made it
    seconds: float          # 0.0 when an earlier build was reused
    reused: bool

    def resources(self) -> List[Dict[str, object]]:
        """Per-kernel registers / spill bytes / static shared memory, parsed
        from the ptxas log."""
        return parse_ptxas_log(self.log_path.read_text())


def build_dir() -> Path:
    override = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if override:
        return Path(override)
    # src/repro_torch/kernels/_build.py -> repository root
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest(srcs: List[Path]) -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for src in srcs + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise CompileError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA kernels of "
        "repro_torch are compiled on the machine that runs them"
    )


def build() -> BuildInfo:
    """Compile ``csrc/*.cu`` (one ``nvcc`` per source, all started together),
    link them into ``libkernels_<digest>.so`` and return where it is."""
    srcs = sources()
    digest = _digest(srcs)
    out_dir = build_dir()
    lib = out_dir / f"libkernels_{digest}.so"
    log_path = out_dir / f"libkernels_{digest}.log"
    if lib.exists() and log_path.exists():
        return BuildInfo(lib, log_path, 0.0, True)

    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    tag = f"{digest}.{os.getpid()}"
    objs = [out_dir / f"{src.stem}.{tag}.o" for src in srcs]
    procs = [
        subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for src, obj in zip(srcs, objs)
    ]
    log: List[str] = []
    failed: Optional[str] = None
    for src, proc in zip(srcs, procs):
        out, _ = proc.communicate()
        log.append(f"==> {src.name}\n{out}")
        if proc.returncode != 0 and failed is None:
            failed = src.name
    try:
        if failed is not None:
            raise CompileError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        tmp = out_dir / f"libkernels_{tag}.so.tmp"
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        log.append(f"==> link\n{link.stdout}")
        if link.returncode != 0:
            raise CompileError("nvcc failed to link:\n" + "\n".join(log))
        log_path.write_text("\n".join(log))
        os.replace(tmp, lib)  # atomic: a concurrent build sees all or nothing
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    return BuildInfo(lib, log_path, time.perf_counter() - t0, False)


_LIB: Optional[ctypes.CDLL] = None
_INFO: Optional[BuildInfo] = None


def load() -> ctypes.CDLL:
    """The built library, compiled on the first call of the process."""
    global _LIB, _INFO
    if _LIB is None:
        _INFO = build()
        _LIB = ctypes.CDLL(str(_INFO.path))
    return _LIB


def info() -> BuildInfo:
    """How the loaded library was built (builds and loads it if needed)."""
    load()
    assert _INFO is not None
    return _INFO


_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_SPILL = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?")


def parse_ptxas_log(text: str) -> List[Dict[str, object]]:
    """One record per ``Compiling entry function`` block of ``ptxas -v``."""
    records: List[Dict[str, object]] = []
    cur: Optional[Dict[str, object]] = None
    for line in text.splitlines():
        entry = _ENTRY.search(line)
        if entry:
            cur = {"kernel": entry.group(1), "registers": None, "stack_bytes": 0,
                   "spill_store_bytes": 0, "spill_load_bytes": 0, "static_smem_bytes": 0}
            records.append(cur)
            continue
        if cur is None:
            continue
        spill = _SPILL.search(line)
        if spill:
            cur["stack_bytes"], cur["spill_store_bytes"], cur["spill_load_bytes"] = (
                int(g) for g in spill.groups()
            )
        used = _USED.search(line)
        if used:
            cur["registers"] = int(used.group(1))
            cur["static_smem_bytes"] = int(used.group(2) or 0)
    return records
