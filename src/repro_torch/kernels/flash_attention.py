"""Flash attention: the wrapper of the CUDA kernel, its plain version, its plan.

Counterpart of ``repro.kernels.flash_attention``.  The kernel itself is
``csrc/flash_attention.cu`` (CUDA C++ for ``sm_90a``; the source says which TPU
kernel it replaces, what bounds each of its paths and what their designs do
about it).  Here:

* :func:`flash_attention` — the wrapper, in the model layout ``(B, S, H, Dh)``
  with grouped-query heads.  For a CUDA tensor it launches the kernel or
  raises; for a CPU tensor it runs the plain version.  ``flash_attention.launches``
  counts kernel launches, one per call whatever the path (a plain integer,
  raised where the kernel is launched and nowhere else);
  ``flash_attention.launches_by_path`` splits the same count by path;
* :func:`flash_attention_plain` — the chosen path's arithmetic in PyTorch
  (online softmax over the path's KV tiles, the tiles it skips, the split-KV
  partials and their combine, the finite ``NEG_INF``, ``acc / max(l, 1e-30)``);
  what the CPU tests run and what the kernel is held against on the card;
* :func:`tile_plan` — the masked-tile skipping rule as a plain function;
* :func:`choose_tile` — the chooser of a :class:`Plan` over
  ``{path, BQ, BKV, stages, splits}``.  On this card the scarce resources
  are the shared memory a block may take and the registers a thread may hold;
  the chooser trades them as the paper trades registers against shared memory
  and occupancy.  Whatever it returns is launchable: ragged lengths are masked
  inside the kernel, so no length needs to divide a tile.

Which path serves which call: ``fma`` every float32 call (plain FMAs, no TF32);
``split`` bfloat16 calls whose query rows per kv head (``Sq * Hq / Hkv``) are at
most 16 (8 above Dh = 128) — decode; ``mma`` the other bfloat16 calls — prefill.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from .ref import NEG_INF, attention_mask, floor_div

#: "no restriction" for ``window`` / ``chunk``: the model passes per-layer values
BIG = 1 << 30

#: dynamic shared memory one block may take on an H100 (227 KB of the SM's 256 KB)
SMEM_PER_BLOCK = 227 * 1024
#: shared memory of one SM that blocks share (each also holds 1 KB for the system)
SMEM_PER_SM = 228 * 1024
#: registers one thread may hold
MAX_REGISTERS = 255
#: streaming multiprocessors of an H100 SXM
SMS = 132
#: the fma path runs 256 threads as 16 row groups x 16 column lanes
THREADS = 256
_LANES = 16
#: the mma and split paths run four warps
MMA_THREADS = SPLIT_THREADS = 128

PATHS = ("fma", "mma", "split")
_PATH_CODE = {"fma": 0, "mma": 1, "split": 2}

#: the fma path's tiles
TILE_Q = (64, 16)
TILE_KV = (64, 32)
#: the mma path: 64 query rows (16 a warp), KV tiles of 64 or 32 keys, 2 stages
MMA_BQ = 64
MMA_TILE_KV = (64, 32)
MMA_STAGES = 2
#: the split path: 32-key warp tiles, at most 16 query rows a block, in row classes
SPLIT_KEYS = 32
SPLIT_ROWS = (1, 4, 8, 16)
#: above Dh = 128 at most 8: 16 rows' accumulators (128 floats a lane) would spill
SPLIT_ROWS_WIDE = 8
_PAD = 8  # bf16 elements of padding a shared-memory row

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_LAUNCH_ERRORS = {
    -1: "head width must be a multiple of 16, at most 256",
    -2: "no instantiation for this tile or row count",
    -3: "element type must be float32 or bfloat16",
    -4: "shape out of range (empty, B*Hq > 65535, window/chunk < 1) or no workspace",
    -5: "the path does not take this element type",
}


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch: the path, its tile, its pipeline depth and its KV split.

    ``bq`` is the query rows a block owns (split: the row class of
    ``Sq * groups``), ``bkv`` the keys of one tile (split: of one warp's tile),
    ``stages`` the depth of the copy ring, fixed by the path and head width
    when the kernel is compiled (fma: none), ``splits`` the blocks one
    (batch, kv head) is split over (split path only; else 1)."""

    path: str
    bq: int
    bkv: int
    stages: int
    splits: int
    threads: int


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
    """Dynamic shared memory of one fma block: fp32 Q, K (row stride ``Dh + 1``), V
    and P tiles plus the two int32 position tiles (the kernel's own formula)."""
    floats = bq * head_dim + bkv * (head_dim + 1) + bkv * head_dim + bq * bkv
    return 4 * floats + 4 * (bq + bkv)


def _flag_bytes(seq_kv: int, tile: int) -> int:
    return (-(-seq_kv // tile) + 15) & ~15


def split_stages(head_dim: int) -> int:
    """Stages of a split warp's copy ring (compiled in): two up to Dh = 128,
    one above, where two would not fit a block's shared memory."""
    return 1 if head_dim > 128 else 2


def mma_smem_bytes(head_dim: int, bkv: int, seq_kv: int) -> int:
    """One mma block: bf16 Q and the K / V rings (rows padded by 16 bytes), the
    kpos ring, qpos, the seen-rows word and two flags a KV tile (the kernel's formula)."""
    row = 2 * (head_dim + _PAD)
    stages = MMA_STAGES
    return (MMA_BQ * row + 2 * stages * bkv * row + 4 * stages * bkv + 4 * MMA_BQ + 16
            + 2 * _flag_bytes(seq_kv, bkv))


def split_smem_bytes(head_dim: int, rows: int, seq_kv: int) -> int:
    """One split block of row class ``rows``: four warps' K / V rings, fp32 q
    rows, each warp's p, the kpos rings, qpos, seen rows, tile flags."""
    row = 2 * (head_dim + _PAD)
    warps = SPLIT_THREADS // 32
    stages = split_stages(head_dim)
    return (2 * warps * stages * SPLIT_KEYS * row + 4 * rows * head_dim
            + 4 * warps * SPLIT_KEYS * rows + 4 * warps * stages * SPLIT_KEYS
            + 4 * SPLIT_ROWS[-1] + 16 + 2 * _flag_bytes(seq_kv, SPLIT_KEYS))


def plan_smem_bytes(plan: Plan, head_dim: int, seq_kv: int) -> int:
    if plan.path == "fma":
        return smem_bytes(head_dim, plan.bq, plan.bkv)
    if plan.path == "mma":
        return mma_smem_bytes(head_dim, plan.bkv, seq_kv)
    return split_smem_bytes(head_dim, plan.bq, seq_kv)


def accumulator_registers(head_dim: int, bq: int, bkv: int) -> int:
    """Registers an fma thread spends on carried state: ``acc`` and the score tile."""
    return (bq // _LANES) * (_column_class(head_dim) + bkv // _LANES) + 2 * (bq // _LANES)


def mma_accumulator_registers(head_dim: int, bkv: int) -> int:
    """Registers an mma thread spends on carried state: ``acc`` (Dh/2), the score
    fragments (BKV/2), ``m`` and ``l`` (4), and Q's A fragments (Dh/4) where
    they are kept in registers (up to Dh = 128)."""
    dhc = 64 if head_dim <= 64 else 80 if head_dim == 80 else 128 if head_dim <= 128 else 256
    return dhc // 2 + bkv // 2 + 4 + (dhc // 4 if dhc <= 128 else 0)


def _snap(wanted: int, tiles: Tuple[int, ...]) -> int:
    """The largest instantiated tile not above ``wanted`` (else the smallest)."""
    for t in tiles:
        if t <= wanted:
            return t
    return tiles[-1]


def split_rows(head_dim: int) -> int:
    """The most query rows a split block serves at ``head_dim``."""
    return SPLIT_ROWS[-1] if head_dim <= 128 else SPLIT_ROWS_WIDE


def _row_class(rows: int, head_dim: int) -> int:
    for rc in SPLIT_ROWS:
        if rows <= min(rc, split_rows(head_dim)):
            return rc
    raise ValueError(f"the split path serves at most {split_rows(head_dim)} query rows at "
                     f"head width {head_dim}, got {rows}")


def default_splits(seq_kv: int, batch_kv_heads: int, smem: int) -> int:
    """Blocks per (batch, kv head): as many as one wave of resident blocks
    holds (blocks of ``smem`` bytes on ``SMS`` SMs), but no fewer than one warp
    tile for each of a block's four warps.  One wave, not several: each block
    pays a fixed set-up (positions, pre-pass, merge, combine), and on the card
    more splits than one wave were slower (``PERF.md``)."""
    tiles = -(-seq_kv // SPLIT_KEYS)
    resident = SMS * max(1, SMEM_PER_SM // (smem + 1024))
    return max(1, min(resident // max(1, batch_kv_heads), tiles // (SPLIT_THREADS // 32)))


def choose_path(seq_q: int, head_dim: int, dtype: torch.dtype, groups: int = 1) -> str:
    """fp32 -> ``fma``; bf16 with at most :func:`split_rows` query rows a kv
    head -> ``split``; other bf16 -> ``mma``."""
    if dtype != torch.bfloat16:
        return "fma"
    return "split" if seq_q * groups <= split_rows(head_dim) else "mma"


def choose_tile(
    seq_q: int, seq_kv: int, head_dim: int,
    block_q: Optional[int] = None, block_kv: Optional[int] = None,
    smem_budget: int = SMEM_PER_BLOCK,
    *, dtype: torch.dtype = torch.float32, groups: int = 1, batch_kv_heads: int = 1,
    path: Optional[str] = None, splits: Optional[int] = None,
) -> Plan:
    """Pick the :class:`Plan` of one launch.

    The path follows :func:`choose_path` unless ``path`` names one (the plain
    version's arithmetic; ``mma`` and ``split`` take bf16 only, ``split`` at
    most :func:`split_rows` rows a kv head).  fma: a short query (decode)
    takes the 16-row tile, anything longer the 64-row one; mma: 64 rows, 64-key tiles (32
    above Dh = 128), two stages; split: the row class of ``seq_q * groups``,
    32-key warp tiles in :func:`split_stages` stages, ``default_splits``
    blocks a (batch, kv head) unless ``splits`` is given.  ``block_q`` /
    ``block_kv`` override the tile, snapped down to one the kernel is
    instantiated for.  The tile is then shrunk (the KV tile, then the query
    tile) until its shared memory fits ``smem_budget``; a plan that still
    does not fit raises ``ValueError``.  Lengths need not divide the tile, so
    the result is always launchable.
    """
    _check_head_dim(head_dim)
    path = path or choose_path(seq_q, head_dim, dtype, groups)
    if path not in PATHS:
        raise ValueError(f"path must be one of {PATHS}, got {path!r}")
    if path != "fma" and dtype != torch.bfloat16:
        raise TypeError(f"the {path} path takes bfloat16 inputs, got {dtype}")

    if path == "fma":
        bq = _snap(block_q, TILE_Q) if block_q else (
            TILE_Q[-1] if seq_q <= TILE_Q[-1] else TILE_Q[0])
        bkv = _snap(block_kv, TILE_KV) if block_kv else (
            TILE_KV[-1] if seq_kv <= TILE_KV[-1] else TILE_KV[0]
        )
        if smem_bytes(head_dim, bq, bkv) > smem_budget:
            bkv = TILE_KV[-1]
        if smem_bytes(head_dim, bq, bkv) > smem_budget:
            bq = TILE_Q[-1]
        plan = Plan("fma", bq, bkv, 1, 1, THREADS)
        assert accumulator_registers(head_dim, bq, bkv) < MAX_REGISTERS
    elif path == "mma":
        bkv = _snap(block_kv, MMA_TILE_KV) if block_kv else (
            MMA_TILE_KV[0] if head_dim <= 128 else MMA_TILE_KV[-1])
        if mma_smem_bytes(head_dim, bkv, seq_kv) > smem_budget:
            bkv = MMA_TILE_KV[-1]
        plan = Plan("mma", MMA_BQ, bkv, MMA_STAGES, 1, MMA_THREADS)
        assert mma_accumulator_registers(head_dim, bkv) < MAX_REGISTERS
    else:
        rc = _row_class(seq_q * groups, head_dim)
        smem = split_smem_bytes(head_dim, rc, seq_kv)
        n = default_splits(seq_kv, batch_kv_heads, smem) if splits is None else int(splits)
        if n < 1:
            raise ValueError(f"splits must be at least 1, got {n}")
        plan = Plan("split", rc, SPLIT_KEYS, split_stages(head_dim), n, SPLIT_THREADS)
    if plan_smem_bytes(plan, head_dim, seq_kv) > smem_budget:
        raise ValueError(
            f"no {path} tile of head width {head_dim} fits {smem_budget} bytes of shared memory"
        )
    return plan


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------


def _mask_args(window: Optional[int], chunk: Optional[int]) -> Tuple[int, int]:
    window = BIG if window is None else min(int(window), BIG)
    chunk = BIG if chunk is None else min(int(chunk), BIG)
    if window < 1 or chunk < 1:
        raise ValueError(f"window and chunk must be positive, got {window}, {chunk}")
    return window, chunk


def tile_plan(
    q_positions: torch.Tensor,   # (B, Sq) integer
    kv_positions: torch.Tensor,  # (B, Skv) integer
    tile: int,
    block_rows: int,
    window: Optional[int] = None,
    chunk: Optional[int] = None,
) -> torch.Tensor:
    """The masked-tile skipping rule, decided as the kernel's pre-pass decides it.

    Query rows are cut into blocks of ``block_rows`` (the rows one block serves:
    64 on the mma path, all ``Sq`` on the split path) and keys into tiles of
    ``tile``.  Returns ``use (B, blocks, tiles)``, the tiles each block walks.
    A tile is skipped only if every live row of the block sees at least one key
    somewhere in the whole range (decided exactly) and no row of the block may
    see a key of the tile (a conservative test against the rows' smallest and
    largest position).  Skipping is then exact: those rows' running max is
    finite, so a masked score adds ``exp(-1e30 - m) = 0``.
    """
    window, chunk = _mask_args(window, chunk)
    b, sq = q_positions.shape
    skv = kv_positions.shape[1]
    nblk, ntiles = -(-sq // block_rows), -(-skv // tile)
    qp = q_positions.long()
    kp = kv_positions.long()
    pad = nblk * block_rows - sq
    live = torch.nn.functional.pad(torch.ones_like(qp, dtype=torch.bool), (0, pad))
    live = live.view(b, nblk, block_rows)
    qb = torch.nn.functional.pad(qp, (0, pad)).view(b, nblk, block_rows)
    qmin = torch.where(live, qb, torch.full_like(qb, 2**62)).amin(-1)[..., None]
    qmax = torch.where(live, qb, torch.full_like(qb, -2**62)).amax(-1)[..., None]
    kx = kp[:, None, :]
    kc = floor_div(kx, chunk)
    maybe = ((kx >= 0) & (kx <= qmax) & (kx > qmin - window)
             & (kc >= floor_div(qmin, chunk)) & (kc <= floor_div(qmax, chunk)))
    maybe = torch.nn.functional.pad(maybe, (0, ntiles * tile - skv))
    flags = maybe.view(b, nblk, ntiles, tile).any(-1)
    sees = attention_mask(qp[:, :, None], kp[:, None, :], window, chunk).any(-1)
    sees = torch.nn.functional.pad(sees, (0, pad), value=True).view(b, nblk, block_rows)
    return flags | ~sees.all(-1)[..., None]


def _online(qf, k, v, kv_positions, qp, use_rows, t_begin, t_end, tile, window, chunk, scale,
            round_p):
    """``(m, l, acc)`` of the online softmax over the tiles ``[t_begin, t_end)``;
    a row takes tile t only where ``use_rows[:, row, t]``."""
    b, sq, hkv, groups, dh = qf.shape
    m = torch.full((b, hkv, groups, sq), NEG_INF, dtype=torch.float32, device=qf.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, hkv, groups, sq, dh), dtype=torch.float32, device=qf.device)
    for t in range(t_begin, t_end):
        kv0 = t * tile
        kt = k[:, kv0:kv0 + tile].float()
        vt = v[:, kv0:kv0 + tile].float()
        kp = kv_positions[:, None, None, None, kv0:kv0 + tile]
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kt) * scale
        s = torch.where(attention_mask(qp, kp, window, chunk), s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        pv = p.to(torch.bfloat16).float() if round_p else p
        u = use_rows[:, None, None, :, t]
        if not bool(u.any()):
            continue
        l = torch.where(u, l * corr + p.sum(dim=-1), l)
        acc = torch.where(u[..., None],
                          acc * corr[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", pv, vt), acc)
        m = torch.where(u, m_new, m)
    return m, l, acc


def combine_splits(parts):
    """The split path's combine of per-split ``(m, l, acc)``:
    ``m = max m_i``, ``l = sum l_i e^(m_i - m)``, ``acc = sum acc_i e^(m_i - m)``."""
    ms = torch.stack([pm for pm, _, _ in parts])
    m = ms.amax(0)
    e = torch.exp(ms - m)
    l = (torch.stack([pl for _, pl, _ in parts]) * e).sum(0)
    acc = (torch.stack([pa for _, _, pa in parts]) * e[..., None]).sum(0)
    return m, l, acc


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
    path: Optional[str] = None,
    splits: Optional[int] = None,
) -> torch.Tensor:
    """The chosen path's arithmetic in PyTorch, output in ``q``'s dtype.

    Online softmax over the KV tiles the path takes, in fp32, walking only the
    tiles :func:`tile_plan` keeps (mma: per 64-row block; split: per batch
    row).  On the split path each batch row's tiles to visit are shared out
    among the splits as the kernel shares them (split i takes visit indices
    ``[i * n_vis // splits, (i + 1) * n_vis // splits)``), each split's
    ``(m, l, acc)`` is computed on its own and they are merged by
    :func:`combine_splits`.  On the mma path P is rounded to bfloat16 before
    the ``P V`` product, as the tensor cores take it (``l`` sums the unrounded
    P, as the kernel does); the fma and split paths keep P in fp32.  ``path``
    may name any path whatever the dtype: this runs that path's arithmetic.
    Query rows are independent, so they are not tiled here."""
    b, sq, hq, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    groups = hq // hkv
    window, chunk = _mask_args(window, chunk)
    scale = 1.0 / math.sqrt(dh) if scale is None else scale
    # any path's arithmetic runs on any dtype here (the kernel takes mma and
    # split in bfloat16 only): the CPU tests hold it in float32 at 2e-5
    plan = choose_tile(sq, skv, dh, block_q, block_kv,
                       dtype=torch.bfloat16 if path in ("mma", "split") else q.dtype,
                       groups=groups, batch_kv_heads=b * hkv, path=path, splits=splits)
    tile = plan.bkv
    ntiles = -(-skv // tile)
    if plan.path == "fma":
        use_rows = torch.ones((b, sq, ntiles), dtype=torch.bool, device=q.device)
    else:
        block_rows = MMA_BQ if plan.path == "mma" else sq
        use = tile_plan(q_positions, kv_positions, tile, block_rows, window, chunk)
        use_rows = use[:, torch.arange(sq, device=q.device) // block_rows]

    qf = q.float().reshape(b, sq, hkv, groups, dh)
    qp = q_positions[:, None, None, :, None]
    args = (qf, k, v, kv_positions, qp, use_rows)
    rest = (tile, window, chunk, scale, plan.path == "mma")
    if plan.path == "split":
        # the splits share out each batch row's tiles to visit, as the kernel does
        n = plan.splits
        visit = use[:, 0, :]
        rank = visit.long().cumsum(-1) - 1
        nvis = visit.long().sum(-1, keepdim=True)
        parts = []
        for i in range(n):
            mine = visit & (rank >= i * nvis // n) & (rank < (i + 1) * nvis // n)
            parts.append(_online(*args[:5], mine[:, None, :].expand(b, sq, ntiles), 0, ntiles,
                                 *rest))
        _, l, acc = combine_splits(parts)
    else:
        _, l, acc = _online(*args, 0, ntiles, *rest)
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
            + [i32, i32, ctypes.c_float] + [i32] * 6 + [ptr, ptr, ptr]
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


#: per device: the split path's tickets, one int32 a (batch, kv head), as many
#: as a grid may have; zero between launches (the last block of each launch
#: resets its own).  Launches on one stream run one after another; split-path
#: launches of one device must not run concurrently on two streams.
_TICKETS: Dict[int, torch.Tensor] = {}
_MAX_BATCH_KV_HEADS = 65535


def _tickets(device: torch.device) -> torch.Tensor:
    t = _TICKETS.get(device.index)
    if t is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "flash_attention: the split path allocates its tickets at its first call; "
                "make one call outside the CUDA graph capture first"
            )
        t = torch.zeros(_MAX_BATCH_KV_HEADS, dtype=torch.int32, device=device)
        _TICKETS[device.index] = t
    return t


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
    splits: Optional[int] = None,
) -> torch.Tensor:
    """Causal / windowed / chunked attention by the CUDA kernel.

    Tensors on a CUDA device go to the kernel, enqueued on the current stream
    (no synchronisation, no copy of q / k / v: any strides with a contiguous
    last dimension are read as they are); anything the kernel does not take
    raises.  Tensors on the CPU go to :func:`flash_attention_plain`.  The path
    follows the dtype and query rows (:func:`choose_path`); ``splits``
    overrides the split path's count.  The tile skip and the split combine are
    decided on the device: nothing here reads a value back, so a call may be
    captured in a CUDA graph once a first call has allocated the split path's
    tickets.
    """
    _check(q, k, v, q_positions, kv_positions)
    b, sq, hq, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    plan = choose_tile(sq, skv, dh, block_q, block_kv, dtype=q.dtype, groups=hq // hkv,
                       batch_kv_heads=b * hkv, splits=splits)
    if q.device.type == "cpu":
        return flash_attention_plain(
            q, k, v, q_positions, kv_positions, window, chunk, block_q, block_kv, scale,
            splits=splits,
        )
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention runs on cuda or cpu tensors, not {q.device}")

    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name} must be contiguous in its last dimension")
    window, chunk = _mask_args(window, chunk)
    scale = 1.0 / math.sqrt(dh) if scale is None else float(scale)
    # 16-byte loads where every row of q, k and v starts on a 16-byte boundary
    vec = int(all(_aligned16(t) for t in (q, k, v)))
    qp = q_positions.to(torch.int32)
    kp = kv_positions.to(torch.int32)
    out = torch.empty((b, sq, hq, dh), dtype=q.dtype, device=q.device)

    fn = _kernel_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        ws = tickets = None
        if plan.path == "split" and plan.splits > 1:
            ws = torch.empty(b * hkv * plan.splits * SPLIT_ROWS[-1] * (dh + 2),
                             dtype=torch.float32, device=q.device)
            tickets = _tickets(q.device)
        rc = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), qp.data_ptr(), kp.data_ptr(), out.data_ptr(),
            b, sq, skv, hq, hkv, dh,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            out.stride(0), out.stride(1), out.stride(2),
            qp.stride(0), qp.stride(1), kp.stride(0), kp.stride(1),
            window, chunk, scale, _DTYPE_CODE[q.dtype], _PATH_CODE[plan.path],
            plan.bq, plan.bkv, plan.splits, vec,
            None if ws is None else ws.data_ptr(),
            None if tickets is None else tickets.data_ptr(), stream,
        )
    if rc != 0:
        why = _LAUNCH_ERRORS.get(rc, f"CUDA error {rc}")
        raise RuntimeError(
            f"flash_attention kernel was not launched ({why}): q {tuple(q.shape)} "
            f"k {tuple(k.shape)} {q.dtype} plan {plan}"
        )
    flash_attention.launches += 1
    flash_attention.launches_by_path[plan.path] += 1
    return out


flash_attention.launches = 0
flash_attention.launches_by_path = {p: 0 for p in PATHS}
