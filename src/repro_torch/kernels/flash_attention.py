"""Flash attention: the wrapper of the CUDA kernel, its plain version, its tiles.

Counterpart of ``repro.kernels.flash_attention``.  The kernel itself is
``csrc/flash_attention.cu`` (CUDA C++ for ``sm_90a``; the source says which TPU
kernel it replaces, what bounds it and what its design does about it).  Here:

* :func:`flash_attention` — the wrapper, in the model layout ``(B, S, H, Dh)``
  with grouped-query heads.  For a CUDA tensor it launches the kernel or
  raises; for a CPU tensor it runs the plain version.  ``flash_attention.launches``
  counts kernel launches (a plain integer, raised where the kernel is launched
  and nowhere else);
* :func:`flash_attention_plain` — the same block-wise online softmax written
  in PyTorch, tile for tile the kernel's arithmetic (fp32 products, the finite
  ``NEG_INF``, ``acc / max(l, 1e-30)``); what the CPU tests run and what the
  kernel is held against on the card;
* :func:`choose_tile` — the tile chooser.  On this card the scarce resources
  are the shared memory a block may take and the registers a thread may hold;
  the chooser trades them as the paper trades registers against shared memory
  and occupancy.  Whatever it returns is launchable: ragged lengths are masked
  inside the kernel, so no length needs to divide a tile.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from .ref import NEG_INF, attention_mask

#: "no restriction" for ``window`` / ``chunk``: the model passes per-layer values
BIG = 1 << 30

#: dynamic shared memory one block may take on an H100 (227 KB of the SM's 256 KB)
SMEM_PER_BLOCK = 227 * 1024
#: registers one thread may hold
MAX_REGISTERS = 255
#: every instantiation runs 256 threads as 16 row groups x 16 column lanes
THREADS = 256
_LANES = 16

#: the tiles the kernel is instantiated for
TILE_Q = (64, 16)
TILE_KV = (64, 32)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_LAUNCH_ERRORS = {
    -1: "head width must be a multiple of 16, at most 256",
    -2: "no instantiation for this tile",
    -3: "element type must be float32 or bfloat16",
    -4: "shape out of range (empty, B*Hq > 65535, or window/chunk < 1)",
}


def _check_head_dim(head_dim: int) -> None:
    if head_dim <= 0 or head_dim % 16 or head_dim > 256:
        raise ValueError(
            f"flash_attention takes a head width that is a multiple of 16 up to 256, got {head_dim}"
        )


def _column_class(head_dim: int) -> int:
    """Output columns a thread owns: the instantiated class covering ``head_dim / 16``."""
    if head_dim <= 64:
        return 4
    if head_dim == 80:
        return 5
    return 8 if head_dim <= 128 else 16


def smem_bytes(head_dim: int, bq: int, bkv: int) -> int:
    """Dynamic shared memory of one block: fp32 Q, K (row stride ``Dh + 1``), V
    and P tiles plus the two int32 position tiles (the kernel's own formula)."""
    floats = bq * head_dim + bkv * (head_dim + 1) + bkv * head_dim + bq * bkv
    return 4 * floats + 4 * (bq + bkv)


def accumulator_registers(head_dim: int, bq: int, bkv: int) -> int:
    """Registers a thread spends on carried state: ``acc`` and the score tile."""
    return (bq // _LANES) * (_column_class(head_dim) + bkv // _LANES) + 2 * (bq // _LANES)


def _snap(wanted: int, tiles: Tuple[int, ...]) -> int:
    """The largest instantiated tile not above ``wanted`` (else the smallest)."""
    for t in tiles:
        if t <= wanted:
            return t
    return tiles[-1]


def choose_tile(
    seq_q: int, seq_kv: int, head_dim: int,
    block_q: Optional[int] = None, block_kv: Optional[int] = None,
    smem_budget: int = SMEM_PER_BLOCK,
) -> Tuple[int, int, int]:
    """Pick ``(BQ, BKV, threads)`` for one launch.

    A short query (decode) takes the 16-row tile, anything longer the 64-row
    one; ``block_q`` / ``block_kv`` override that, snapped down to a tile the
    kernel is instantiated for.  The tile is then shrunk (KV first: it costs
    no extra passes over K and V) until its shared memory fits ``smem_budget``.
    Lengths need not divide the tile, so the result is always launchable.
    """
    _check_head_dim(head_dim)
    bq = _snap(block_q, TILE_Q) if block_q else (TILE_Q[-1] if seq_q <= TILE_Q[-1] else TILE_Q[0])
    bkv = _snap(block_kv, TILE_KV) if block_kv else (
        TILE_KV[-1] if seq_kv <= TILE_KV[-1] else TILE_KV[0]
    )
    if smem_bytes(head_dim, bq, bkv) > smem_budget:
        bkv = TILE_KV[-1]
    if smem_bytes(head_dim, bq, bkv) > smem_budget:
        bq = TILE_Q[-1]
    if smem_bytes(head_dim, bq, bkv) > smem_budget:
        raise ValueError(
            f"no tile of head width {head_dim} fits {smem_budget} bytes of shared memory"
        )
    assert accumulator_registers(head_dim, bq, bkv) < MAX_REGISTERS
    return bq, bkv, THREADS


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------


def _mask_args(window: Optional[int], chunk: Optional[int]) -> Tuple[int, int]:
    window = BIG if window is None else min(int(window), BIG)
    chunk = BIG if chunk is None else min(int(chunk), BIG)
    if window < 1 or chunk < 1:
        raise ValueError(f"window and chunk must be positive, got {window}, {chunk}")
    return window, chunk


def flash_attention_plain(
    q: torch.Tensor,             # (B, Sq, Hq, Dh)
    k: torch.Tensor,             # (B, Skv, Hkv, Dh)
    v: torch.Tensor,             # (B, Skv, Hkv, Dh)
    q_positions: torch.Tensor,   # (B, Sq) integer
    kv_positions: torch.Tensor,  # (B, Skv) integer
    window: Optional[int] = None,
    chunk: Optional[int] = None,
    block_q: Optional[int] = None,
    block_kv: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch: online softmax over KV tiles of the
    size the kernel would take, fp32 throughout, output in ``q``'s dtype.
    Query rows are independent, so they are not tiled here."""
    b, sq, hq, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    groups = hq // hkv
    window, chunk = _mask_args(window, chunk)
    scale = 1.0 / math.sqrt(dh) if scale is None else scale
    _, bkv, _ = choose_tile(sq, skv, dh, block_q, block_kv)

    qf = q.float().reshape(b, sq, hkv, groups, dh)
    qp = q_positions[:, None, None, :, None]
    m = torch.full((b, hkv, groups, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, hkv, groups, sq, dh), dtype=torch.float32, device=q.device)
    for kv0 in range(0, skv, bkv):
        kt = k[:, kv0:kv0 + bkv].float()
        vt = v[:, kv0:kv0 + bkv].float()
        kp = kv_positions[:, None, None, None, kv0:kv0 + bkv]
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kt) * scale
        s = torch.where(attention_mask(qp, kp, window, chunk), s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p, vt)
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, dh).to(q.dtype)


# ---------------------------------------------------------------------------
# The wrapper
# ---------------------------------------------------------------------------

_FN = None


def _kernel_fn():
    """The C entry point, built and bound on first use."""
    global _FN
    if _FN is None:
        from . import _build

        fn = _build.load().repro_flash_attention
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        fn.argtypes = (
            [ptr] * 6 + [i32] * 6 + [i64] * 16
            + [i32, i32, ctypes.c_float, i32, i32, i32, i32, ptr]
        )
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _check(q, k, v, q_positions, kv_positions) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, S, H, Dh)")
    b, sq, hq, dh = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != dh:
        raise ValueError(f"k/v shapes {tuple(k.shape)}, {tuple(v.shape)} do not match q {tuple(q.shape)}")
    if hq % k.shape[2]:
        raise ValueError(f"{hq} query heads are not a multiple of {k.shape[2]} kv heads")
    if q_positions.shape != (b, sq) or kv_positions.shape != (b, k.shape[1]):
        raise ValueError("positions must be (B, Sq) and (B, Skv)")
    if q_positions.dtype.is_floating_point or kv_positions.dtype.is_floating_point:
        raise TypeError("positions must be integer tensors")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODE:
        raise TypeError(
            f"q, k, v must share float32 or bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}"
        )
    if any(t.requires_grad for t in (q, k, v)) and torch.is_grad_enabled():
        raise RuntimeError(
            "flash_attention is forward only (as the kernel it replaces): detach the "
            "inputs or run under torch.no_grad(); train through impl='xla' or 'chunked'"
        )
    devices = {t.device for t in (q, k, v, q_positions, kv_positions)}
    if len(devices) != 1:
        raise ValueError(f"all tensors must be on one device, got {sorted(map(str, devices))}")
    _check_head_dim(dh)


def _aligned16(t: torch.Tensor) -> bool:
    size = t.element_size()
    return t.data_ptr() % 16 == 0 and all(t.stride(i) * size % 16 == 0 for i in range(3))


def flash_attention(
    q: torch.Tensor,             # (B, Sq, Hq, Dh)
    k: torch.Tensor,             # (B, Skv, Hkv, Dh)
    v: torch.Tensor,             # (B, Skv, Hkv, Dh)
    q_positions: torch.Tensor,   # (B, Sq) integer
    kv_positions: torch.Tensor,  # (B, Skv) integer
    window: Optional[int] = None,
    chunk: Optional[int] = None,
    block_q: Optional[int] = None,
    block_kv: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Causal / windowed / chunked attention by the CUDA kernel.

    Tensors on a CUDA device go to the kernel, enqueued on the current stream
    (no synchronisation, no copy of q / k / v: any strides with a contiguous
    last dimension are read as they are); anything the kernel does not take
    raises.  Tensors on the CPU go to :func:`flash_attention_plain`.
    """
    _check(q, k, v, q_positions, kv_positions)
    if q.device.type == "cpu":
        return flash_attention_plain(
            q, k, v, q_positions, kv_positions, window, chunk, block_q, block_kv, scale
        )
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention runs on cuda or cpu tensors, not {q.device}")

    b, sq, hq, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name} must be contiguous in its last dimension")
    window, chunk = _mask_args(window, chunk)
    scale = 1.0 / math.sqrt(dh) if scale is None else float(scale)
    bq, bkv, _ = choose_tile(sq, skv, dh, block_q, block_kv)
    # 16-byte loads where every row of q, k and v starts on a 16-byte boundary
    vec = int(all(_aligned16(t) for t in (q, k, v)))
    qp = q_positions.to(torch.int32)
    kp = kv_positions.to(torch.int32)
    out = torch.empty((b, sq, hq, dh), dtype=q.dtype, device=q.device)

    fn = _kernel_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), qp.data_ptr(), kp.data_ptr(), out.data_ptr(),
            b, sq, skv, hq, hkv, dh,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            out.stride(0), out.stride(1), out.stride(2),
            qp.stride(0), qp.stride(1), kp.stride(0), kp.stride(1),
            window, chunk, scale, _DTYPE_CODE[q.dtype], bq, bkv, vec, stream,
        )
    if rc != 0:
        why = _LAUNCH_ERRORS.get(rc, f"CUDA error {rc}")
        raise RuntimeError(
            f"flash_attention kernel was not launched ({why}): q {tuple(q.shape)} "
            f"k {tuple(k.shape)} {q.dtype} tile ({bq}, {bkv})"
        )
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
