"""Training attention: the CUDA forward and backward, their plain version, one autograd function.

The kernels are ``csrc/train_attention.cu`` (CUDA C++ for ``sm_90a``; the
source says that they replace no TPU kernel, what bounds them and what their
design does about it).  They compute what
:func:`repro_torch.models.attention.attention_chunked` computes, and its
gradients, on the tensor cores.  Here:

* :func:`train_attention` — the ``torch.autograd.Function`` in the model
  layout ``(B, S, H, Dh)`` with grouped-query heads: the forward saves its
  output and ``LSE = m + log l`` (fp32, ``(B, Hq, Sq)``), the backward
  recomputes P from them.  For CUDA tensors every step launches a kernel or
  raises; for CPU tensors it runs the plain version.  ``launches_by_kernel``
  counts the launches of each of the four kernels (plain integers, raised
  where a kernel is launched and nowhere else);
* :func:`train_attention_plain_forward` / :func:`train_attention_plain_backward`
  — the same arithmetic in PyTorch on the whole score matrix, the backward's
  recomputation from LSE written out: what the CPU tests hold against
  autograd through the chunked loop and against the JAX reference's
  gradient, and what the kernels are held against on the card.  In bfloat16
  P and dS are rounded to bfloat16 before their products, as the kernels
  round them; in float32 nothing is rounded.

A row that sees no key gets what the chunked loop gives it: the mean of the
value rows over the keys padded to whole chunks (``pad_keys``), LSE = +inf
as its mark, no gradient to q or k, and ``dO / pad_keys`` to every key's dv.
Positions lie in ``(-2**30, 2**30)``; ``window`` and ``chunk`` are ``None``
(unrestricted) or positive.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from .flash_attention import _mask_args
from .ref import attention_mask

#: the kernels' tiles: 64 query rows a forward or dq block (16 a warp) and 32 keys
#: a KV tile; 64 keys a dkdv block (16 a warp) and 32 query rows a tile
BLOCK_Q = 64
TILE_KV = 32
BLOCK_KEYS = 64
TILE_Q = 32
STAGES = 2
#: widest head the kernels take (the dkdv accumulators of a wider one would spill)
MAX_HEAD_DIM = 128
_PAD = 8  # bf16 elements of padding a shared-memory row
#: the four kernels, by their short names
KERNELS = ("fwd", "bwd_dot", "bwd_dkdv", "bwd_dq")
_LAUNCH_ERRORS = {
    -1: "head width must be a multiple of 16, at most 128",
    -4: "shape out of range (empty, B*Hq > 65535, window/chunk < 1, pad_keys < Skv)",
}


def _pad16(n: int) -> int:
    return (n + 15) & ~15


def smem_bytes(kernel: str, head_dim: int, seq_q: int, seq_kv: int, groups: int = 1) -> int:
    """Dynamic shared memory of one block of ``kernel`` (the kernels' own formulas)."""
    row = 2 * (head_dim + _PAD)
    if kernel == "bwd_dkdv":
        ntq = -(-seq_q // TILE_Q)
        return (2 * BLOCK_KEYS * row + 2 * STAGES * TILE_Q * row + 3 * STAGES * TILE_Q * 4
                + BLOCK_KEYS * 4 + _pad16(groups * ntq) + 2 * _pad16(ntq))
    tiles = {"fwd": 1, "bwd_dq": 2}[kernel]
    ntiles = -(-seq_kv // TILE_KV)
    return (tiles * BLOCK_Q * row + 2 * STAGES * TILE_KV * row + STAGES * TILE_KV * 4
            + BLOCK_Q * 4 + 2 * _pad16(ntiles))


def takes_head_dim(head_dim: int) -> bool:
    """Whether the kernels take this head width: a multiple of 16 up to 128."""
    return 0 < head_dim <= MAX_HEAD_DIM and head_dim % 16 == 0


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------


def _rounder(dtype: torch.dtype):
    if dtype == torch.bfloat16:
        return lambda x: x.to(torch.bfloat16).float()
    return lambda x: x


def _scores(q, k, q_positions, kv_positions, window, chunk, scale):
    """``s (B, Hkv, G, Sq, Skv)`` in fp32 and the mask, broadcastable to it."""
    b, sq, hq, dh = q.shape
    hkv = k.shape[2]
    qf = q.float().reshape(b, sq, hkv, hq // hkv, dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) * scale
    vis = attention_mask(q_positions[:, None, None, :, None],
                         kv_positions[:, None, None, None, :], window, chunk)
    return qf, s, vis


def _defaults(q, k, scale, pad_keys):
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)
    return scale, k.shape[1] if pad_keys is None else int(pad_keys)


def train_attention_plain_forward(
    q: torch.Tensor,             # (B, Sq, Hq, Dh)
    k: torch.Tensor,             # (B, Skv, Hkv, Dh)
    v: torch.Tensor,             # (B, Skv, Hkv, Dh)
    q_positions: torch.Tensor,   # (B, Sq) integer
    kv_positions: torch.Tensor,  # (B, Skv) integer
    window: Optional[int] = None,
    chunk: Optional[int] = None,
    scale: Optional[float] = None,
    pad_keys: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out (B, Sq, Hq, Dh) in q's dtype, lse (B, Hq, Sq) fp32)``."""
    scale, pad_keys = _defaults(q, k, scale, pad_keys)
    b, sq, hq, dh = q.shape
    _, s, vis = _scores(q, k, q_positions, kv_positions, window, chunk, scale)
    empty = ~vis.any(-1)
    m = torch.where(vis, s, torch.full_like(s, -math.inf)).amax(-1)
    m = torch.where(empty, torch.zeros_like(m), m)
    p = torch.where(vis, torch.exp(s - m[..., None]), torch.zeros_like(s))
    l = p.sum(-1)
    acc = torch.einsum("bhgqk,bkhd->bhgqd", _rounder(q.dtype)(p), v.float())
    out = acc / l.clamp_min(1e-30)[..., None]
    mean = v.float().sum(1)[:, :, None, None, :] / pad_keys
    out = torch.where(empty[..., None], mean, out)
    lse = torch.where(empty, torch.full_like(m, math.inf), m + torch.log(l))
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, dh).to(q.dtype)
    return out, lse.reshape(b, hq, sq)


def train_attention_plain_backward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,           # the forward's output
    lse: torch.Tensor,           # (B, Hq, Sq) fp32, the forward's
    dout: torch.Tensor,          # (B, Sq, Hq, Dh)
    q_positions: torch.Tensor,
    kv_positions: torch.Tensor,
    window: Optional[int] = None,
    chunk: Optional[int] = None,
    scale: Optional[float] = None,
    pad_keys: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` in the inputs' dtypes, by recomputation from LSE:
    ``P = exp(S scale - LSE)`` (``1 / pad_keys`` on every key of a row marked
    +inf), ``D = rowsum(dO * O)``, ``dS = P * (dO V^T - D)`` where the mask
    shows the pair, ``dV = P^T dO``, ``dQ = scale dS K``, ``dK = scale dS^T Q``."""
    scale, pad_keys = _defaults(q, k, scale, pad_keys)
    b, sq, hq, dh = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    rnd = _rounder(q.dtype)
    qf, s, vis = _scores(q, k, q_positions, kv_positions, window, chunk, scale)
    lse = lse.reshape(b, hkv, g, sq)[..., None]
    empty = torch.isinf(lse)
    p = torch.where(vis, torch.exp(s - lse),
                    torch.where(empty, torch.full_like(s, 1.0 / pad_keys), torch.zeros_like(s)))
    do = dout.float().reshape(b, sq, hkv, g, dh)
    dsum = (do * out.float().reshape(b, sq, hkv, g, dh)).sum(-1).permute(0, 2, 3, 1)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", rnd(p), do)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", do, v.float())
    ds = torch.where(vis, p * (dp - dsum[..., None]), torch.zeros_like(s))
    dq = scale * torch.einsum("bhgqk,bkhd->bqhgd", rnd(ds), k.float())
    dk = scale * torch.einsum("bhgqk,bqhgd->bkhd", rnd(ds), qf)
    return dq.reshape(b, sq, hq, dh).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------------

_FNS = None


def _kernel_fns():
    """The C entry points, built and bound on first use."""
    global _FNS
    if _FNS is None:
        from . import _build

        lib = _build.load()
        ptr, i32, strides = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int64)
        fwd = lib.repro_train_attention_forward
        fwd.argtypes = [ptr] * 7 + [i32] * 6 + [strides, i32, i32, i32, ctypes.c_float, ptr]
        fwd.restype = ctypes.c_int
        bwd = lib.repro_train_attention_backward
        bwd.argtypes = [ptr] * 12 + [i32] * 6 + [strides, i32, i32, i32, ctypes.c_float, ptr]
        bwd.restype = ctypes.c_int
        _FNS = fwd, bwd
    return _FNS


def _check(q, k, v, q_positions, kv_positions) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, S, H, Dh)")
    b, sq, hq, dh = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != dh:
        raise ValueError(f"k/v shapes {tuple(k.shape)}, {tuple(v.shape)} do not match "
                         f"q {tuple(q.shape)}")
    if hq % k.shape[2]:
        raise ValueError(f"{hq} query heads are not a multiple of {k.shape[2]} kv heads")
    if q_positions.shape != (b, sq) or kv_positions.shape != (b, k.shape[1]):
        raise ValueError("positions must be (B, Sq) and (B, Skv)")
    if q_positions.dtype.is_floating_point or kv_positions.dtype.is_floating_point:
        raise TypeError("positions must be integer tensors")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k, v must share a dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    devices = {t.device for t in (q, k, v, q_positions, kv_positions)}
    if len(devices) != 1:
        raise ValueError(f"all tensors must be on one device, got {sorted(map(str, devices))}")


def _on_card(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise RuntimeError(f"train_attention runs on cuda or cpu tensors, not {t.device}")
    return True


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` if its last dimension is contiguous and every row starts on a
    16-byte boundary (the kernels' 16-byte copies), else a fresh copy."""
    size = t.element_size()
    if t.stride(3) == 1 and t.data_ptr() % 16 == 0 and all(
            t.stride(i) * size % 16 == 0 for i in range(3)):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _strides(*ts: torch.Tensor):
    vals = [s for t in ts for s in t.stride()[:3]]
    return (ctypes.c_int64 * 12)(*vals, *([0] * (12 - len(vals))))


def _raise(rc: int, what: str, q: torch.Tensor, k: torch.Tensor) -> None:
    why = _LAUNCH_ERRORS.get(rc, f"CUDA error {rc}")
    raise RuntimeError(f"train_attention {what} was not launched ({why}): q {tuple(q.shape)} "
                       f"k {tuple(k.shape)} {q.dtype}")


def _kernel_inputs(q, k, v, q_positions, kv_positions):
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the training attention kernels take bfloat16, got {q.dtype}")
    if not takes_head_dim(q.shape[-1]):
        raise ValueError(f"the training attention kernels take a head width that is a multiple "
                         f"of 16 up to {MAX_HEAD_DIM}, got {q.shape[-1]}")
    qp = q_positions.to(torch.int32).contiguous()
    kp = kv_positions.to(torch.int32).contiguous()
    return _aligned(q), _aligned(k), _aligned(v), qp, kp


def train_attention_forward(q, k, v, q_positions, kv_positions, window=None, chunk=None,
                            scale=None, pad_keys=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out, lse)``: the kernel for CUDA tensors (enqueued on the current
    stream, nothing read back), the plain version for CPU tensors."""
    _check(q, k, v, q_positions, kv_positions)
    if not _on_card(q):
        return train_attention_plain_forward(q, k, v, q_positions, kv_positions, window, chunk,
                                             scale, pad_keys)
    scale, pad_keys = _defaults(q, k, scale, pad_keys)
    window, chunk = _mask_args(window, chunk)
    q, k, v, qp, kp = _kernel_inputs(q, k, v, q_positions, kv_positions)
    b, sq, hq, dh = q.shape
    out = torch.empty((b, sq, hq, dh), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    fwd, _ = _kernel_fns()
    with torch.cuda.device(q.device):
        rc = fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), qp.data_ptr(), kp.data_ptr(),
                 out.data_ptr(), lse.data_ptr(), b, sq, k.shape[1], hq, k.shape[2], dh,
                 _strides(q, k, v), window, chunk, pad_keys, scale,
                 torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        _raise(rc, "forward", q, k)
    train_attention.launches_by_kernel["fwd"] += 1
    return out, lse


def train_attention_backward(q, k, v, out, lse, dout, q_positions, kv_positions, window=None,
                             chunk=None, scale=None, pad_keys=None):
    """``(dq, dk, dv)``: the three backward kernels for CUDA tensors, in
    order on the current stream, the plain version for CPU tensors.  Two runs
    on the same inputs give the same gradients bit for bit."""
    _check(q, k, v, q_positions, kv_positions)
    if not _on_card(q):
        return train_attention_plain_backward(q, k, v, out, lse, dout, q_positions, kv_positions,
                                              window, chunk, scale, pad_keys)
    scale, pad_keys = _defaults(q, k, scale, pad_keys)
    window, chunk = _mask_args(window, chunk)
    q, k, v, qp, kp = _kernel_inputs(q, k, v, q_positions, kv_positions)
    dout = _aligned(dout.to(q.dtype))
    out, lse = out.contiguous(), lse.contiguous()
    b, sq, hq, dh = q.shape
    dq = torch.empty((b, sq, hq, dh), dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=q.device)
    dsum = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    _, bwd = _kernel_fns()
    with torch.cuda.device(q.device):
        rc = bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
                 lse.data_ptr(), qp.data_ptr(), kp.data_ptr(), dsum.data_ptr(), dq.data_ptr(),
                 dk.data_ptr(), dv.data_ptr(), b, sq, k.shape[1], hq, k.shape[2], dh,
                 _strides(q, k, v, dout), window, chunk, pad_keys, scale,
                 torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        _raise(rc, "backward", q, k)
    for name in KERNELS[1:]:
        train_attention.launches_by_kernel[name] += 1
    return dq, dk, dv


class _TrainAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, q_positions, kv_positions, window, chunk, scale, pad_keys):
        out, lse = train_attention_forward(q, k, v, q_positions, kv_positions, window, chunk,
                                           scale, pad_keys)
        ctx.save_for_backward(q, k, v, out, lse, q_positions, kv_positions)
        ctx.mask = (window, chunk, scale, pad_keys)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, q_positions, kv_positions = ctx.saved_tensors
        dq, dk, dv = train_attention_backward(q, k, v, out, lse, dout, q_positions,
                                              kv_positions, *ctx.mask)
        return dq, dk, dv, None, None, None, None, None, None


def train_attention(
    q: torch.Tensor,             # (B, Sq, Hq, Dh)
    k: torch.Tensor,             # (B, Skv, Hkv, Dh)
    v: torch.Tensor,             # (B, Skv, Hkv, Dh)
    q_positions: torch.Tensor,   # (B, Sq) integer
    kv_positions: torch.Tensor,  # (B, Skv) integer
    window: Optional[int] = None,
    chunk: Optional[int] = None,
    scale: Optional[float] = None,
    pad_keys: Optional[int] = None,
) -> torch.Tensor:
    """Attention with a gradient: the forward and backward kernels for CUDA
    tensors (bfloat16, a head width that is a multiple of 16 up to 128; else
    it raises), their plain version for CPU tensors.  ``pad_keys`` (at least
    ``Skv``; ``Skv`` if not given) is the key count a row that sees no key
    averages over."""
    return _TrainAttention.apply(q, k, v, q_positions, kv_positions, window, chunk, scale,
                                 pad_keys)


train_attention.launches_by_kernel = {name: 0 for name in KERNELS}
