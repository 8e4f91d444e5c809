"""Mamba-2 SSD chunk scan: the wrapper of the CUDA kernel, its plain version, its plan.

Counterpart of ``repro.kernels.mamba2_ssd``.  The kernel itself is
``csrc/mamba2_ssd.cu`` (CUDA C++ for ``sm_90a``; the source says which TPU
kernel it replaces, what bounds it and what its two paths do about it).  Here:

* :func:`mamba2_ssd` — the wrapper.  ``x (B, S, H, P)``, ``dt (B, S, H)``,
  ``a (H,)``, ``bm`` / ``cm (B, S, N)`` in the model's layout, read through
  their strides (``x``, ``bm`` and ``cm`` may be column slices of one wider
  tensor, as the model's are); an optional initial state ``h0 (B, H, P, N)``;
  any ``S >= 1``.  Returns ``y (B, S, H, P)`` in ``out_dtype`` (``x``'s dtype
  unless asked for float32) and the last state ``h (B, H, P, N)`` in float32.
  For a CUDA tensor it launches the kernel or raises; for a CPU tensor it runs
  the plain version.  ``mamba2_ssd.launches`` counts kernel launches (a plain
  integer, raised where the kernel is launched and nowhere else), one per call
  whatever the path; ``mamba2_ssd.launches_by_path`` splits the same count;
* :func:`ssd_plain` — the kernel's arithmetic in PyTorch, fp32 throughout:
  the quadratic dual form over chunks of :data:`CHUNK` rows with the state
  carried between chunks.  What the CPU tests run and what the kernel is held
  against on the card.  Both paths keep near-fp32 products (the ``mma`` path
  feeds each fp32 operand to the tensor cores as two bfloat16 halves), so it
  needs no path of its own;
* :func:`choose_plan` — the chooser of a :class:`Plan`: the path and the
  state rows a block owns.

Which path serves which call: ``fma`` every float32 call (CUDA-core FMAs, no
TF32); ``mma`` every bfloat16 call (tensor cores) — the model's.

The chunk length is the kernel's own, 64 rows, not the reference's 256: the
SSD result does not depend on it in exact arithmetic, and 64 rows of ``B`` and
``C`` fit a block's shared memory where 256 do not.  ``p_block`` is the number
of the state's rows one block owns (rows of ``h`` evolve independently), the
port's counterpart of the reference's ``head_block``: it trades recomputing
``C Bᵀ`` against blocks to fill the card, and does not change the result.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import torch

#: rows of the chunk the kernel walks (its shared-memory tile)
CHUNK = 64
#: threads of one block on either path: the fma path's 16 x 16, the mma path's eight warps
THREADS = 256
#: state rows one block may own, and state widths, the kernel is instantiated for
P_BLOCKS = (16, 32, 64)
STATE_WIDTHS = (16, 32, 64, 128)
PATHS = ("fma", "mma")
_PATH_CODE = {"fma": 0, "mma": 1}
_PAD = 8  # bf16 elements of padding a shared-memory row (mma path)

#: an H100 SXM: streaming multiprocessors, the shared memory a block may take
#: and an SM holds (each block also holds 1 KB for the system), its registers
SMS = 132
SMEM_PER_BLOCK = 227 * 1024
SMEM_PER_SM = 228 * 1024
REGISTERS_PER_SM = 65536

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_LAUNCH_ERRORS = {
    -1: "state width N must be one of 16, 32, 64, 128",
    -2: "no instantiation for this p_block",
    -3: "element type must be float32 or bfloat16",
    -4: "shape out of range (empty, or B or H above 65535)",
    -5: "the path does not take this element type",
}


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch: the path, the state rows a block owns, and what follows
    from them on an H100 — the blocks of the grid, the threads and dynamic
    shared memory of one, how many an SM holds (:func:`resident_blocks`) and
    the waves the grid takes."""

    path: str
    p_block: int
    blocks: int
    threads: int
    smem_bytes: int
    resident: int
    waves: int


def choose_path(dtype: torch.dtype) -> str:
    """fp32 -> ``fma``; bf16 -> ``mma``."""
    return "mma" if dtype == torch.bfloat16 else "fma"


def smem_bytes(n: int, p_block: int, path: str = "fma") -> int:
    """Dynamic shared memory of one block (the kernel's own formulas).

    fma: fp32 B and C tiles (row stride ``N + 1``), the ``(Q, Q)`` weight tile
    (row stride ``Q + 1``), the x and ``dt·decay·x`` tiles, the state snapshot
    (row stride ``N + 1``) and four per-row vectors.  mma: two stages of bf16
    B, C (row stride ``N + 8``) and x (``p_block + 8``) rows and fp32 dt, two
    snapshots of h as bf16 hi and lo halves (row stride ``N + 8``), the fp32
    partial y that one warp of each row tile hands the other, and each of the
    eight warps' ``da_cum``, coefficient and decay rows."""
    q = CHUNK
    if path == "fma":
        floats = 2 * q * (n + 1) + q * (q + 1) + 2 * q * p_block + p_block * (n + 1) + 4 * q
        return 4 * floats
    if path == "mma":
        stage = 2 * q * (n + _PAD) * 2 + q * (p_block + _PAD) * 2 + q * 4
        return (2 * stage + 2 * 2 * p_block * (n + _PAD) * 2 + 4 * q * p_block
                + (THREADS // 32) * 3 * q * 4)
    raise ValueError(f"path must be one of {PATHS}, got {path!r}")


#: registers a thread of each instantiation holds, ``(path, N, p_block)``, as
#: ptxas gives them (``-Xptxas -v``, nvcc 12.9, ``sm_90a``).  The build phase
#: of ``chip_smoke.py`` requires the compiled kernels to hold no more, so the
#: occupancy that :func:`resident_blocks` counts from them is never above the
#: card's
REGISTERS = {
    ("fma", 16, 16): 64, ("fma", 16, 32): 62, ("fma", 16, 64): 64,
    ("fma", 32, 16): 52, ("fma", 32, 32): 57, ("fma", 32, 64): 64,
    ("fma", 64, 16): 48, ("fma", 64, 32): 64, ("fma", 64, 64): 78,
    ("fma", 128, 16): 60, ("fma", 128, 32): 63, ("fma", 128, 64): 128,
    ("mma", 16, 16): 114, ("mma", 16, 32): 118, ("mma", 16, 64): 130,
    ("mma", 32, 16): 114, ("mma", 32, 32): 124, ("mma", 32, 64): 175,
    ("mma", 64, 16): 112, ("mma", 64, 32): 122, ("mma", 64, 64): 198,
    ("mma", 128, 16): 157, ("mma", 128, 32): 186, ("mma", 128, 64): 212,
}


def resident_blocks(n: int, p_block: int, path: str) -> int:
    """Blocks one SM holds at once: the least of what its shared memory, its
    registers (:data:`REGISTERS`, allocated 8 a thread at a time) and its
    2,048 threads allow."""
    regs = -(-REGISTERS[(path, n, p_block)] // 8) * 8
    by_smem = SMEM_PER_SM // (smem_bytes(n, p_block, path) + 1024)
    return max(0, min(by_smem, REGISTERS_PER_SM // (THREADS * regs), 2048 // THREADS))


def choose_plan(
    batch: int, heads: int, head_dim: int, state: int, dtype: torch.dtype,
    p_block: Optional[int] = None,
) -> Plan:
    """Pick the :class:`Plan` of one launch.

    The path follows the dtype (:func:`choose_path`).  Unless ``p_block``
    names one, the state rows a block owns are those of :data:`P_BLOCKS`
    that divide ``head_dim`` and whose grid runs in the fewest waves of
    resident blocks (:func:`resident_blocks` on the card's :data:`SMS` SMs),
    and of those the fewest.  The chunks of a block run in series, so a block
    is bound by latency, which grows with its state rows; a second wave
    doubles the time.  On the card (``PERF.md``): one prompt of mamba2_370m
    (128 blocks at 16 rows, one an SM) ran fastest at 16 rows, one of
    zamba2_2_7b at 32 rows (160 blocks, two an SM) rather than 16 (320
    blocks, two waves) or 64 (80 blocks).  Raises ``ValueError`` for a head width, state width or
    ``p_block`` the kernel has no instantiation for."""
    if head_dim <= 0 or head_dim % P_BLOCKS[0]:
        raise ValueError(
            f"mamba2_ssd takes a head width P that is a multiple of 16, got {head_dim}"
        )
    if state not in STATE_WIDTHS:
        raise ValueError(f"mamba2_ssd takes a state width N in {STATE_WIDTHS}, got {state}")
    path = choose_path(dtype)
    fits = [ps for ps in P_BLOCKS
            if head_dim % ps == 0 and smem_bytes(state, ps, path) <= SMEM_PER_BLOCK]
    if p_block is not None and int(p_block) not in fits:
        raise ValueError(
            f"p_block must be one of {P_BLOCKS} and divide P = {head_dim}, got {p_block}"
        )

    def plan(ps: int) -> Plan:
        blocks = batch * heads * (head_dim // ps)
        resident = resident_blocks(state, ps, path)
        return Plan(path, ps, blocks, THREADS, smem_bytes(state, ps, path), resident,
                    -(-blocks // (SMS * resident)))

    if p_block is not None:
        return plan(int(p_block))
    return min((plan(ps) for ps in fits), key=lambda pl: (pl.waves, pl.p_block))


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------


def ssd_plain(
    x: torch.Tensor,    # (B, S, H, P)
    dt: torch.Tensor,   # (B, S, H)
    a: torch.Tensor,    # (H,)
    bm: torch.Tensor,   # (B, S, N)
    cm: torch.Tensor,   # (B, S, N)
    h0: Optional[torch.Tensor] = None,      # (B, H, P, N)
    out_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's arithmetic: per chunk of ``CHUNK`` rows (the last one
    short), ``da_cum = cumsum(dt a)``, ``y = ((C Bᵀ) ∘ L ∘ dt) x +
    exp(da_cum) ∘ (C hᵀ)``, ``h ← exp(da_total) h + Bᵀ (dt exp(da_total −
    da_cum) x)``; fp32 throughout, ``y`` rounded once at the end."""
    B, S, H, P = x.shape
    out_dtype = out_dtype or x.dtype
    af = a.float()
    if h0 is None:
        h = torch.zeros((B, H, P, bm.shape[-1]), dtype=torch.float32, device=x.device)
    else:
        h = h0.float()
    ys = []
    for c0 in range(0, S, CHUNK):
        xc = x[:, c0:c0 + CHUNK].float()             # (B, q, H, P)
        dtc = dt[:, c0:c0 + CHUNK].float()           # (B, q, H)
        bc = bm[:, c0:c0 + CHUNK].float()            # (B, q, N)
        cc = cm[:, c0:c0 + CHUNK].float()
        q = xc.shape[1]
        cum = torch.cumsum(dtc * af, dim=1).transpose(1, 2)       # (B, H, q)
        total = cum[:, :, -1]                                     # (B, H)
        tri = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
        diff = cum[..., :, None] - cum[..., None, :]              # (B, H, i, j)
        decay = torch.where(tri, torch.exp(diff), torch.zeros_like(diff))
        scores = torch.einsum("bin,bjn->bij", cc, bc)
        w = scores[:, None] * decay * dtc.transpose(1, 2)[:, :, None, :]
        inter = torch.einsum("bin,bhpn->bhip", cc, h)
        y = torch.einsum("bhij,bjhp->bhip", w, xc) + torch.exp(cum)[..., None] * inter
        ys.append(y.permute(0, 2, 1, 3))                          # (B, q, H, P)
        coef = dtc * torch.exp(total[:, None, :] - cum.transpose(1, 2))   # (B, q, H)
        u = xc * coef[..., None]
        h = h * torch.exp(total)[:, :, None, None] + torch.einsum("bjn,bjhp->bhpn", bc, u)
    return torch.cat(ys, dim=1).to(out_dtype), h


# ---------------------------------------------------------------------------
# The wrapper
# ---------------------------------------------------------------------------

_FN = None


def _kernel_fn():
    """The C entry point, built and bound on first use."""
    global _FN
    if _FN is None:
        from . import _build

        fn = _build.load().repro_mamba2_ssd
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        fn.argtypes = [ptr] * 8 + [i32] * 5 + [i64] * 13 + [i32] * 6 + [ptr]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _check(x, dt, a, bm, cm, h0, out_dtype) -> None:
    if x.dim() != 4 or dt.dim() != 3 or a.dim() != 1 or bm.dim() != 3 or cm.dim() != 3:
        raise ValueError("mamba2_ssd takes x (B,S,H,P), dt (B,S,H), a (H,), bm / cm (B,S,N)")
    B, S, H, P = x.shape
    N = bm.shape[-1]
    if dt.shape != (B, S, H) or a.shape != (H,) or bm.shape != (B, S, N) or cm.shape != bm.shape:
        raise ValueError(
            f"shapes do not agree: x {tuple(x.shape)}, dt {tuple(dt.shape)}, a {tuple(a.shape)}, "
            f"bm {tuple(bm.shape)}, cm {tuple(cm.shape)}"
        )
    if h0 is not None and h0.shape != (B, H, P, N):
        raise ValueError(f"h0 must be {(B, H, P, N)}, got {tuple(h0.shape)}")
    if S < 1:
        raise ValueError("mamba2_ssd needs at least one token")
    if not (x.dtype == bm.dtype == cm.dtype) or x.dtype not in _DTYPE_CODE:
        raise TypeError(
            f"x, bm, cm must share float32 or bfloat16, got {x.dtype}, {bm.dtype}, {cm.dtype}"
        )
    if dt.dtype not in _DTYPE_CODE or a.dtype not in _DTYPE_CODE:
        raise TypeError(f"dt and a must be float32 or bfloat16, got {dt.dtype}, {a.dtype}")
    if h0 is not None and h0.dtype != torch.float32:
        raise TypeError(f"h0 is the float32 state, got {h0.dtype}")
    if out_dtype not in (None, torch.float32, x.dtype):
        raise TypeError(f"y comes out in float32 or in x's dtype {x.dtype}, not {out_dtype}")
    tensors = (x, dt, a, bm, cm) + (() if h0 is None else (h0,))
    if any(t.requires_grad for t in tensors) and torch.is_grad_enabled():
        raise RuntimeError(
            "mamba2_ssd is forward only (as the kernel it replaces): detach the inputs "
            "or run under torch.no_grad(); train through ssd_impl='chunked'"
        )
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"all tensors must be on one device, got {sorted(map(str, devices))}")


def _aligned16(t: torch.Tensor) -> bool:
    size = t.element_size()
    return t.data_ptr() % 16 == 0 and all(s * size % 16 == 0 for s in t.stride()[:-1])


def mamba2_ssd(
    x: torch.Tensor,    # (B, S, H, P)
    dt: torch.Tensor,   # (B, S, H)  post-softplus
    a: torch.Tensor,    # (H,)       negative
    bm: torch.Tensor,   # (B, S, N)
    cm: torch.Tensor,   # (B, S, N)
    h0: Optional[torch.Tensor] = None,       # (B, H, P, N) float32
    p_block: Optional[int] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SSD chunk scan by the CUDA kernel.

    Tensors on a CUDA device go to the kernel, enqueued on the current stream
    (no synchronisation, no copy of x / bm / cm: any strides with a contiguous
    last dimension are read as they are); anything the kernel does not take
    raises.  Tensors on the CPU go to :func:`ssd_plain`.  The path and the
    state rows a block owns follow :func:`choose_plan`; ``p_block`` overrides
    the latter.  Nothing here reads a value back, so a call may be captured in
    a CUDA graph.
    """
    _check(x, dt, a, bm, cm, h0, out_dtype)
    B, S, H, P = x.shape
    N = bm.shape[-1]
    plan = choose_plan(B, H, P, N, x.dtype, p_block)
    if x.device.type == "cpu":
        return ssd_plain(x, dt, a, bm, cm, h0, out_dtype)
    if x.device.type != "cuda":
        raise RuntimeError(f"mamba2_ssd runs on cuda or cpu tensors, not {x.device}")

    for name, t in (("x", x), ("bm", bm), ("cm", cm)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous in its last dimension")
    out_dtype = out_dtype or x.dtype
    a32 = a.float().contiguous()                 # H values
    h0c = None if h0 is None else h0.contiguous()
    # 16-byte copies where every row of x, bm and cm starts on a 16-byte boundary
    vec = int(all(_aligned16(t) for t in (x, bm, cm)))
    y = torch.empty((B, S, H, P), dtype=out_dtype, device=x.device)
    h_last = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)

    fn = _kernel_fn()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(
            x.data_ptr(), dt.data_ptr(), a32.data_ptr(), bm.data_ptr(), cm.data_ptr(),
            None if h0c is None else h0c.data_ptr(), y.data_ptr(), h_last.data_ptr(),
            B, S, H, P, N,
            x.stride(0), x.stride(1), x.stride(2),
            dt.stride(0), dt.stride(1), dt.stride(2),
            bm.stride(0), bm.stride(1), cm.stride(0), cm.stride(1),
            y.stride(0), y.stride(1), y.stride(2),
            _DTYPE_CODE[x.dtype], _DTYPE_CODE[dt.dtype], _DTYPE_CODE[out_dtype], plan.p_block,
            _PATH_CODE[plan.path], vec, stream,
        )
    if rc != 0:
        why = _LAUNCH_ERRORS.get(rc, f"CUDA error {rc}")
        raise RuntimeError(
            f"mamba2_ssd kernel was not launched ({why}): x {tuple(x.shape)} N {N} "
            f"{x.dtype} plan {plan}"
        )
    mamba2_ssd.launches += 1
    mamba2_ssd.launches_by_path[plan.path] += 1
    return y, h_last


mamba2_ssd.launches = 0
mamba2_ssd.launches_by_path = {p: 0 for p in PATHS}
