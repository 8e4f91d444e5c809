"""The port's attention kernel module against the JAX package, on the CPU.

The same inputs, made with numpy from a seed, go through
``repro.kernels.ops.flash_attention`` (the Pallas kernel in interpret mode)
and ``repro.kernels.ref.attention_reference`` on one side, and through the
port's ``flash_attention`` wrapper (which on CPU tensors runs the kernel's
plain PyTorch version) and the port's oracle on the other.  Tolerances are
the reference's own: 2e-5 in float32, 2e-2 in bfloat16 (absolute and
relative).  The CUDA kernel itself is held against the plain version on the
GPU by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref

torch.set_num_threads(1)

F32, BF16 = "float32", "bfloat16"
TOL = {F32: 2e-5, BF16: 2e-2}
JDT = {F32: jnp.float32, BF16: jnp.bfloat16}
TDT = {F32: torch.float32, BF16: torch.bfloat16}


def _inputs(B, Sq, Skv, Hq, Hkv, Dh, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, Hq, Dh), dtype=np.float32)
    k = rng.standard_normal((B, Skv, Hkv, Dh), dtype=np.float32)
    v = rng.standard_normal((B, Skv, Hkv, Dh), dtype=np.float32)
    qpos = np.broadcast_to(np.arange(Skv - Sq, Skv, dtype=np.int32)[None], (B, Sq)).copy()
    kpos = np.broadcast_to(np.arange(Skv, dtype=np.int32)[None], (B, Skv)).copy()
    return q, k, v, qpos, kpos


def _to_jax(arrs, dtype):
    q, k, v, qpos, kpos = arrs
    cast = lambda x: jnp.asarray(x).astype(JDT[dtype])
    return cast(q), cast(k), cast(v), jnp.asarray(qpos), jnp.asarray(kpos)


def _to_torch(arrs, dtype):
    q, k, v, qpos, kpos = arrs
    cast = lambda x: torch.from_numpy(x).to(TDT[dtype])
    return cast(q), cast(k), cast(v), torch.from_numpy(qpos), torch.from_numpy(kpos)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _flat(q, k, v, qpos, kpos, lib):
    """Model layout -> the oracles' (BH, S, Dh), K / V repeated per group."""
    B, Sq, Hq, Dh = q.shape
    g = Hq // k.shape[2]
    if lib is torch:
        tr = lambda x: x.permute(0, 2, 1, 3)
        rep = lambda x, n, ax: x.repeat_interleave(n, ax)
    else:
        tr = lambda x: x.transpose(0, 2, 1, 3)
        rep = lambda x, n, ax: jnp.repeat(x, n, ax)
    qf = tr(q).reshape(B * Hq, Sq, Dh)
    kf = rep(tr(k), g, 1).reshape(B * Hq, -1, Dh)
    vf = rep(tr(v), g, 1).reshape(B * Hq, -1, Dh)
    return qf, kf, vf, rep(qpos, Hq, 0), rep(kpos, Hq, 0)


def _unflat(out, B, Hq, lib):
    out = out.reshape(B, Hq, -1, out.shape[-1])
    return out.permute(0, 2, 1, 3) if lib is torch else out.transpose(0, 2, 1, 3)


def _check_all(arrs, dtype, tol=None, window=None, chunk=None, block_q=None, block_kv=None,
               pallas=True):
    """Port wrapper (plain version) and port oracle vs JAX kernel and JAX oracle."""
    tol = tol or TOL[dtype]
    B, _, Hq, _ = arrs[0].shape
    jq = _to_jax(arrs, dtype)
    tq = _to_torch(arrs, dtype)
    want_oracle = _np(_unflat(
        jref.attention_reference(*_flat(*jq, jnp), window=window, chunk=chunk), B, Hq, jnp))
    got_oracle = _np(_unflat(
        ref.attention_reference(*_flat(*tq, torch), window=window, chunk=chunk), B, Hq, torch))
    before = fa.flash_attention.launches
    got = _np(ops.flash_attention(*tq, window=window, chunk_attn=chunk,
                                  block_q=block_q, block_kv=block_kv))
    assert fa.flash_attention.launches == before, "a CPU tensor must not count as a launch"
    np.testing.assert_allclose(got_oracle, want_oracle, atol=tol, rtol=tol)
    np.testing.assert_allclose(got, want_oracle, atol=tol, rtol=tol)
    if pallas:
        want = _np(jops.flash_attention(*jq, window=window, chunk_attn=chunk,
                                        block_q=block_q, block_kv=block_kv))
        np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


ATTN_SHAPES = [
    # (B, Sq, Skv, Hq, Hkv, Dh) — the sweep of tests/test_kernels.py
    (1, 128, 128, 2, 2, 64),
    (2, 128, 128, 4, 1, 64),
    (2, 64, 256, 4, 2, 128),
    (1, 256, 256, 8, 4, 128),
    (2, 128, 128, 4, 4, 256),
]


@pytest.mark.parametrize("shape", ATTN_SHAPES)
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_flash_attention_shapes_dtypes(shape, dtype):
    _check_all(_inputs(*shape), dtype, block_q=64, block_kv=64)


@pytest.mark.parametrize("window", [16, 64])
def test_flash_attention_sliding_window(window):
    _check_all(_inputs(2, 128, 128, 4, 2, 64), F32, window=window, block_q=64, block_kv=64)


@pytest.mark.parametrize("chunk", [32, 64])
def test_flash_attention_chunked_mask(chunk):
    _check_all(_inputs(2, 128, 128, 4, 2, 64), F32, chunk=chunk, block_q=64, block_kv=64)


@pytest.mark.parametrize("bq,bkv", [(32, 32), (64, 128), (128, 64)])
def test_flash_attention_block_shapes(bq, bkv):
    """Tile shape must not change the math (the demotion-knob invariant)."""
    arrs = _inputs(1, 128, 128, 2, 2, 64)
    _check_all(arrs, F32, block_q=bq, block_kv=bkv)
    tq = _to_torch(arrs, F32)
    base = ops.flash_attention(*tq, block_q=128, block_kv=128)
    out = ops.flash_attention(*tq, block_q=bq, block_kv=bkv)
    np.testing.assert_allclose(_np(out), _np(base), atol=2e-5, rtol=2e-5)


ODD_SHAPES = [
    # (B, Sq, Skv, Hq, Hkv, Dh, window, chunk) — none tile-aligned
    (1, 200, 200, 2, 2, 64, None, None),
    (2, 17, 40, 4, 2, 64, None, None),
    (1, 1, 333, 4, 4, 64, None, None),
    (2, 100, 100, 4, 2, 64, 32, None),
    (1, 200, 200, 2, 2, 64, None, 64),
    (1, 129, 257, 2, 1, 128, None, None),
]


@pytest.mark.parametrize("shape", ODD_SHAPES)
def test_flash_attention_unaligned_lengths(shape):
    *dims, window, chunk = shape
    _check_all(_inputs(*dims), F32, tol=3e-5, window=window, chunk=chunk)


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("sq", [1, 48])
def test_flash_attention_head_width_80(sq, dtype):
    """stablelm_3b's heads: 80 wide, a multiple of 16 but no power of two."""
    _check_all(_inputs(2, sq, 96, 4, 4, 80), dtype, pallas=(dtype == F32))


def test_flash_attention_big_means_unrestricted():
    """The model passes BIG (1 << 30), not None, for "no window / no chunk"."""
    arrs = _inputs(2, 40, 72, 4, 2, 64)
    tq = _to_torch(arrs, F32)
    free = ops.flash_attention(*tq)
    big = ops.flash_attention(*tq, window=fa.BIG, chunk_attn=fa.BIG)
    assert torch.equal(free, big)
    jq = _to_jax(arrs, F32)
    want = _unflat(jref.attention_reference(*_flat(*jq, jnp), window=fa.BIG, chunk=fa.BIG),
                   2, 4, jnp)
    np.testing.assert_allclose(_np(big), _np(want), atol=2e-5, rtol=2e-5)


def test_flash_attention_unequal_positions_per_batch():
    """Decode with unequal slot lengths: one query row a slot, each at its own position."""
    q, k, v, _, kpos = _inputs(4, 1, 64, 4, 2, 64)
    qpos = np.array([[3], [63], [17], [40]], dtype=np.int32)
    _check_all((q, k, v, qpos, kpos), F32, pallas=False)


def test_fully_masked_row_is_mean_of_values():
    """NEG_INF is finite: a row whose every key is masked gets a uniform
    softmax over the keys — no NaN, no zeros — in the port as in the oracle."""
    q, k, v, _, kpos = _inputs(1, 3, 50, 2, 2, 64)
    qpos = np.full((1, 3), -2, dtype=np.int32)       # before every key
    tq = _to_torch((q, k, v, qpos, kpos), F32)
    out = ops.flash_attention(*tq)
    want = torch.from_numpy(v).mean(dim=1, keepdim=True).expand(1, 3, 2, 64)
    np.testing.assert_allclose(_np(out), _np(want), atol=2e-5, rtol=2e-5)
    _check_all((q, k, v, qpos, kpos), F32, pallas=False)


def test_padding_positions_are_masked():
    """kv position -1 marks padding: masked whatever the causal test says."""
    q, k, v, qpos, kpos = _inputs(1, 8, 40, 2, 1, 64)
    kpos[:, 30:] = -1
    _check_all((q, k, v, qpos, kpos), F32, pallas=False)
    tq = _to_torch((q, k, v, qpos, kpos), F32)
    short = ops.flash_attention(tq[0], tq[1][:, :30], tq[2][:, :30], tq[3], tq[4][:, :30])
    np.testing.assert_allclose(_np(ops.flash_attention(*tq)), _np(short), atol=2e-5, rtol=2e-5)


def test_floor_division_of_negative_positions():
    """``//`` floors (C's ``/`` truncates): position -1 is in chunk -1, not 0."""
    x = torch.tensor([-65, -64, -1, 0, 63, 64], dtype=torch.int32)
    assert ref.floor_div(x, 64).tolist() == [-2, -1, -1, 0, 0, 1]
    assert ref.floor_div(x, 64).tolist() == (np.asarray(x) // 64).tolist()


def test_plain_reads_strided_views_without_copy():
    """The wrapper takes the model layout through strides: a window of a longer
    cache and every other head give what contiguous copies give."""
    arrs = _inputs(2, 9, 80, 8, 4, 64)
    q, k, v, qpos, kpos = _to_torch(arrs, F32)
    views = (q[:, :, ::2], k[:, 10:70, ::2], v[:, 10:70, ::2], qpos, kpos[:, 10:70])
    got = ops.flash_attention(*views)
    want = ops.flash_attention(*(t.contiguous() for t in views))
    assert torch.equal(got, want)


def test_alignment_probe_picks_the_load_path():
    """16-byte loads only where every row of an operand starts on a 16-byte
    boundary: base pointer and all three outer strides."""
    t = torch.zeros(2, 8, 4, 16, dtype=torch.bfloat16)
    assert fa._aligned16(t)
    assert fa._aligned16(t[:, 2:, ::2])              # offsets and strides of whole rows
    buf = torch.zeros(t.numel() + 8, dtype=torch.bfloat16)
    assert not fa._aligned16(buf[1:1 + t.numel()].view(t.shape))   # base off by 2 bytes
    odd = torch.zeros(2, 8, 4, 20, dtype=torch.bfloat16)[..., :16]  # rows 40 bytes apart
    assert not fa._aligned16(odd)


# ---------------------------------------------------------------------------
# The tile chooser's contract
# ---------------------------------------------------------------------------


def _tile(plan):
    return plan.bq, plan.bkv, plan.threads


def _launchable(plan, head_dim, skv):
    assert plan.path in fa.PATHS
    assert fa.plan_smem_bytes(plan, head_dim, skv) <= fa.SMEM_PER_BLOCK
    if plan.path == "fma":
        assert plan.bq in fa.TILE_Q and plan.bkv in fa.TILE_KV and plan.threads == fa.THREADS
        assert fa.accumulator_registers(head_dim, plan.bq, plan.bkv) < fa.MAX_REGISTERS
    elif plan.path == "mma":
        assert plan.bq == fa.MMA_BQ and plan.bkv in fa.MMA_TILE_KV
        assert plan.stages == fa.MMA_STAGES and plan.threads == fa.MMA_THREADS
        assert fa.mma_accumulator_registers(head_dim, plan.bkv) < fa.MAX_REGISTERS
    else:
        assert plan.bq in fa.SPLIT_ROWS and plan.bkv == fa.SPLIT_KEYS
        assert plan.stages == fa.split_stages(head_dim)
        assert plan.splits >= 1 and plan.threads == fa.SPLIT_THREADS


@pytest.mark.parametrize("head_dim", [16, 64, 80, 128, 256])
def test_choose_tile_always_launchable(head_dim):
    """Whatever the chooser returns is a plan the kernel is built for, within
    the shared-memory and register limits, for short and odd lengths too."""
    for sq in (1, 7, 17, 100, 120, 127, 129, 200, 333, 4096):
        for skv in (1, 40, 200, 1500, 32768):
            plan = fa.choose_tile(sq, skv, head_dim)
            bq, bkv, threads = _tile(plan)
            assert plan.path == "fma" and plan.splits == 1
            assert bq in fa.TILE_Q and bkv in fa.TILE_KV and threads == fa.THREADS
            assert fa.smem_bytes(head_dim, bq, bkv) <= fa.SMEM_PER_BLOCK
            assert fa.accumulator_registers(head_dim, bq, bkv) < fa.MAX_REGISTERS
            # a decode-sized query takes the small tile
            assert bq == 16 if sq <= 16 else bq == 64
            # the same lengths in bfloat16, with and without grouped heads
            for groups in (1, 4, 7):
                bf = fa.choose_tile(sq, skv, head_dim, dtype=torch.bfloat16, groups=groups,
                                    batch_kv_heads=8)
                _launchable(bf, head_dim, skv)
                assert bf.path == ("split" if sq * groups <= fa.split_rows(head_dim) else "mma")


def test_choose_tile_honours_overrides_and_budget():
    assert _tile(fa.choose_tile(512, 1024, 80)) == (64, 64, 256)
    assert _tile(fa.choose_tile(1, 1024, 80)) == (16, 64, 256)
    # overrides snap down to an instantiated tile, never up
    assert _tile(fa.choose_tile(512, 1024, 80, block_q=16, block_kv=32))[:2] == (16, 32)
    assert _tile(fa.choose_tile(512, 1024, 80, block_q=128, block_kv=128))[:2] == (64, 64)
    assert _tile(fa.choose_tile(512, 1024, 80, block_q=32, block_kv=48))[:2] == (16, 32)
    assert _tile(fa.choose_tile(512, 1024, 80, block_q=8, block_kv=8))[:2] == (16, 32)
    bf = dict(dtype=torch.bfloat16)
    assert fa.choose_tile(512, 1024, 80, block_kv=48, **bf).bkv == 32
    assert fa.choose_tile(512, 1024, 80, block_kv=128, **bf).bkv == 64
    # a smaller budget never yields a larger tile, and is respected
    big = fa.choose_tile(4096, 4096, 256)
    small = fa.choose_tile(4096, 4096, 256, smem_budget=100 * 1024)
    assert small.bq * small.bkv <= big.bq * big.bkv
    assert fa.smem_bytes(256, small.bq, small.bkv) <= 100 * 1024
    with pytest.raises(ValueError):
        fa.choose_tile(4096, 4096, 256, smem_budget=16 * 1024)
    for budget in (100 * 1024, 160 * 1024, 200 * 1024):
        for sq, groups in ((1, 1), (1, 16), (4096, 1)):
            full = fa.choose_tile(sq, 4096, 128, groups=groups, **bf)
            if full.path == "split" and fa.plan_smem_bytes(full, 128, 4096) > budget:
                # the split path's tile and stages are compiled in: nothing to shrink
                with pytest.raises(ValueError):
                    fa.choose_tile(sq, 4096, 128, groups=groups, smem_budget=budget, **bf)
                continue
            tight = fa.choose_tile(sq, 4096, 128, groups=groups, smem_budget=budget, **bf)
            assert tight.bkv * tight.stages <= full.bkv * full.stages
            assert fa.plan_smem_bytes(tight, 128, 4096) <= budget
    with pytest.raises(ValueError):
        fa.choose_tile(1, 4096, 256, groups=8, smem_budget=64 * 1024, **bf)


def test_chooser_picks_the_path():
    """Decode-sized ``Sq x groups`` takes split, long bf16 queries mma, fp32 fma;
    overrides are held to what each path takes."""
    bf = torch.bfloat16
    assert fa.choose_tile(1, 1024, 80, dtype=bf, batch_kv_heads=256).path == "split"
    assert fa.choose_tile(1, 1024, 128, dtype=bf, groups=7, batch_kv_heads=32).path == "split"
    assert fa.choose_tile(2, 1024, 128, dtype=bf, groups=8, batch_kv_heads=8).path == "split"
    assert fa.choose_tile(3, 1024, 128, dtype=bf, groups=8).path == "mma"
    assert fa.choose_tile(17, 1024, 80, dtype=bf).path == "mma"
    assert fa.choose_tile(512, 1024, 80, dtype=bf).path == "mma"
    # above Dh = 128 the split path serves at most 8 rows: 9-16 go to mma
    assert fa.choose_tile(2, 1024, 256, dtype=bf, groups=4).path == "split"
    assert fa.choose_tile(4, 1024, 256, dtype=bf, groups=4).path == "mma"
    assert fa.choose_tile(1, 1024, 80).path == "fma"
    assert fa.choose_tile(512, 1024, 80, dtype=torch.float32).path == "fma"
    assert fa.choose_tile(1, 1024, 80, dtype=bf, path="mma").path == "mma"
    assert fa.choose_tile(1, 1024, 80, dtype=bf, path="fma").path == "fma"
    with pytest.raises(TypeError):
        fa.choose_tile(1, 1024, 80, path="split")          # fp32
    with pytest.raises(ValueError):
        fa.choose_tile(17, 1024, 80, dtype=bf, path="split")  # 17 rows
    with pytest.raises(ValueError):
        fa.choose_tile(3, 1024, 256, dtype=bf, groups=4, path="split")  # 12 rows at Dh 256
    with pytest.raises(ValueError):
        fa.choose_tile(1, 1024, 80, dtype=bf, path="wgmma")
    with pytest.raises(ValueError):
        fa.choose_tile(1, 1024, 80, dtype=bf, splits=0)
    # the split count fills one wave of resident blocks, with a tile a warp
    for bhkv, want in ((256, 1), (32, 8), (8, 8), (1000, 1)):
        plan = fa.choose_tile(1, 1024, 80, dtype=bf, batch_kv_heads=bhkv)
        assert plan.splits == want
        per_sm = fa.SMEM_PER_SM // (fa.plan_smem_bytes(plan, 80, 1024) + 1024)
        assert plan.splits == 1 or plan.splits * bhkv <= fa.SMS * per_sm
        assert 4 * plan.splits <= 1024 // fa.SPLIT_KEYS
    assert fa.choose_tile(1, 100, 80, dtype=bf, batch_kv_heads=1).splits == 1
    assert fa.choose_tile(1, 1024, 80, dtype=bf, splits=5).splits == 5


@pytest.mark.parametrize("head_dim", [0, 8, 24, 72, 272])
def test_head_widths_the_kernel_does_not_take(head_dim):
    with pytest.raises(ValueError):
        fa.choose_tile(128, 128, head_dim)
    if head_dim:
        q = torch.zeros(1, 4, 2, head_dim)
        pos = torch.zeros(1, 4, dtype=torch.int32)
        with pytest.raises(ValueError):
            ops.flash_attention(q, q, q, pos, pos)


# ---------------------------------------------------------------------------
# What the wrapper refuses
# ---------------------------------------------------------------------------


def test_wrapper_refuses_what_the_kernel_does_not_take():
    q, k, v, qpos, kpos = _to_torch(_inputs(1, 8, 8, 2, 2, 64), F32)
    with pytest.raises(TypeError):
        ops.flash_attention(q.half(), k.half(), v.half(), qpos, kpos)
    with pytest.raises(TypeError):
        ops.flash_attention(q, k.bfloat16(), v.bfloat16(), qpos, kpos)
    with pytest.raises(TypeError):
        ops.flash_attention(q, k, v, qpos.float(), kpos)
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, v[:, :4], qpos, kpos)
    with pytest.raises(ValueError):
        ops.flash_attention(q, k[:, :, :1].expand(1, 8, 3, 64), v[:, :, :1].expand(1, 8, 3, 64),
                            qpos, kpos)
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, v, qpos, kpos, window=0)
    with pytest.raises(RuntimeError, match="forward only"):
        ops.flash_attention(q.clone().requires_grad_(), k, v, qpos, kpos)
    with torch.no_grad():
        ops.flash_attention(q.clone().requires_grad_(), k, v, qpos, kpos)


def test_build_is_lazy_and_fails_loudly_without_nvcc(monkeypatch, tmp_path):
    """Importing the kernels compiles nothing; asking for the library where
    there is no nvcc raises a CompileError naming it — nothing falls back."""
    from repro_torch.kernels import _build

    assert [p.name for p in _build.sources()] == ["flash_attention.cu", "mamba2_ssd.cu"]
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build.Path, "exists", lambda self: False)
    with pytest.raises(_build.CompileError, match="nvcc"):
        _build.build()
    assert not list(tmp_path.iterdir())


def test_ptxas_log_parser():
    from repro_torch.kernels import _build

    log = """==> flash_attention.cu
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z1kIfLi5ELi4ELi4EEv6Params' for 'sm_90a'
ptxas info    : Function properties for _Z1kIfLi5ELi4ELi4EEv6Params
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 96 registers, used 1 barriers, 572 bytes cmem[0]
ptxas info    : Compiling entry function '_Z1kIfLi16ELi4ELi4EEv6Params' for 'sm_90a'
    24 bytes stack frame, 16 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 255 registers, 128 bytes smem, 572 bytes cmem[0]
"""
    recs = _build.parse_ptxas_log(log)
    assert [r["registers"] for r in recs] == [96, 255]
    assert recs[0]["spill_store_bytes"] == 0 and recs[0]["static_smem_bytes"] == 0
    assert (recs[1]["stack_bytes"], recs[1]["spill_store_bytes"], recs[1]["spill_load_bytes"],
            recs[1]["static_smem_bytes"]) == (24, 16, 8, 128)


# ---------------------------------------------------------------------------
# The bf16 paths' arithmetic: split-KV combine, tile skipping, GQA by rows
# ---------------------------------------------------------------------------


def _oracle_np(arrs, window=None, chunk=None):
    """The JAX oracle in float32, in the model layout."""
    B, _, Hq, _ = arrs[0].shape
    jq = _to_jax(arrs, F32)
    return _np(_unflat(jref.attention_reference(*_flat(*jq, jnp), window=window, chunk=chunk),
                       B, Hq, jnp))


@pytest.mark.parametrize("splits", [1, 2, 5, 40])
def test_split_partials_and_combine_match_one_split_and_oracle(splits):
    """The split path's per-split (m, l, acc) and their combine, in float32:
    1, 2, 5 splits and more splits than the 10 tiles of 32 keys."""
    arrs = _inputs(2, 3, 300, 4, 2, 64)
    tq = _to_torch(arrs, F32)
    one = fa.flash_attention_plain(*tq, path="split", splits=1)
    got = fa.flash_attention_plain(*tq, path="split", splits=splits)
    np.testing.assert_allclose(_np(got), _np(one), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(_np(got), _oracle_np(arrs), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("window", [None, 40])
def test_split_whose_tiles_are_all_masked(window):
    """Queries early in a long cache (and a window that starts mid-tile): the
    later splits skip every tile and contribute (-1e30, 0, 0) to the combine."""
    q, k, v, _, kpos = _inputs(2, 2, 320, 4, 2, 64)
    qpos = np.array([[40, 41], [70, 75]], dtype=np.int32)
    arrs = (q, k, v, qpos, kpos)
    tq = _to_torch(arrs, F32)
    use = fa.tile_plan(tq[3], tq[4], fa.SPLIT_KEYS, 2, window=window)
    assert not use[:, 0, 5:].any() and use[:, 0, :2].any()     # splits 3 and 4 of 5: nothing
    got = fa.flash_attention_plain(*tq, window=window, path="split", splits=5)
    np.testing.assert_allclose(_np(got), _oracle_np(arrs, window=window), atol=2e-5, rtol=2e-5)
    m, l, acc = fa._online(tq[0].float().reshape(2, 2, 2, 2, 64), tq[1], tq[2], tq[4],
                           tq[3][:, None, None, :, None], use[:, [0, 0]], 8, 10,
                           fa.SPLIT_KEYS, window or fa.BIG, fa.BIG, 0.125, False)
    assert (m == ref.NEG_INF).all() and (l == 0).all() and (acc == 0).all()


def _padded_positions():
    """Unequal slot lengths, padding at -1, slots that start mid-tile."""
    kpos = np.broadcast_to(np.arange(200, dtype=np.int32)[None], (3, 200)).copy()
    kpos[0, 150:] = -1
    kpos[1, :37] = -1
    kpos[1, 37:] -= 37
    qpos = np.array([[149, 148, 100], [20, 160, 162], [199, 5, 90]], dtype=np.int32)
    return qpos, kpos


@pytest.mark.parametrize("window,chunk", [(None, None), (24, None), (None, 64), (40, 48)])
@pytest.mark.parametrize("tile,block_rows", [(32, 3), (64, 2)])
def test_skip_rule_is_exact_on_rows_that_see_a_key(window, chunk, tile, block_rows):
    """Walking only the tiles ``tile_plan`` keeps gives, bit for bit, what
    walking every tile gives, for positions that are data (padding, unequal
    slots, windows and chunks that start mid-tile); and some tile is skipped."""
    q, k, v, _, _ = _inputs(3, 3, 200, 2, 1, 32, seed=4)
    qpos, kpos = _padded_positions()
    tq = _to_torch((q, k, v, qpos, kpos), F32)
    w, c = window or fa.BIG, chunk or fa.BIG
    use = fa.tile_plan(tq[3], tq[4], tile, block_rows, window, chunk)
    rows = use[:, torch.arange(3) // block_rows]
    every = torch.ones_like(rows)
    qf = tq[0].float().reshape(3, 3, 1, 2, 32)
    ntiles = -(-200 // tile)
    args = (qf, tq[1], tq[2], tq[4], tq[3][:, None, None, :, None])
    scale = 1 / np.sqrt(32)
    skipped = fa._online(*args, rows, 0, ntiles, tile, w, c, scale, False)
    walked = fa._online(*args, every, 0, ntiles, tile, w, c, scale, False)
    assert not bool(use.all()), "the positions leave a tile to skip"
    for a, b in zip(skipped, walked):
        assert torch.equal(a, b)
    out = skipped[2] / skipped[1].clamp_min(1e-30)[..., None]
    want = _oracle_np((q, k, v, qpos, kpos), window=window, chunk=chunk)
    np.testing.assert_allclose(out.permute(0, 3, 1, 2, 4).reshape(3, 3, 2, 32).numpy(), want,
                               atol=2e-5, rtol=2e-5)


def test_skip_rule_turns_off_when_a_live_row_sees_no_key():
    qpos, kpos = _padded_positions()
    qp, kp = torch.from_numpy(qpos), torch.from_numpy(kpos)
    assert not bool(fa.tile_plan(qp, kp, 32, 3).all())
    qp[1, 1] = -4                       # before every key of slot 1
    use = fa.tile_plan(qp, kp, 32, 3)
    assert bool(use[1].all()) and not bool(use[0].all())
    # blocks of one row: only the block holding that row walks everything
    use = fa.tile_plan(qp, kp, 32, 1)
    assert bool(use[1, 1].all()) and not bool(use[1, 0].all())
    # a fully masked row next to skippable tiles: the mean of all Skv value rows
    q, k, v, _, _ = _inputs(3, 3, 200, 2, 1, 32, seed=4)
    arrs = (q, k, v, qp.numpy(), kpos)
    tq = _to_torch(arrs, F32)
    for path in ("split", "mma"):
        got = _np(fa.flash_attention_plain(*tq, path=path))
        np.testing.assert_allclose(got[1, 1], np.broadcast_to(v[1].mean(axis=0), (2, 32)),
                                   atol=2e-5, rtol=2e-5)
        np.testing.assert_allclose(got, _oracle_np(arrs), atol=3e-3 if path == "mma" else 2e-5,
                                   rtol=2e-5)


@pytest.mark.parametrize("hq,hkv", [(28, 4), (32, 8)])
def test_gqa_by_rows_matches_per_head(hq, hkv):
    """One split block serves every query head of a kv head; at qwen2_7b's
    28/4 and granite_8b's 32/8 (decode, unequal slots) the result is each head's own."""
    q, k, v, _, kpos = _inputs(2, 1, 96, hq, hkv, 16, seed=7)
    qpos = np.array([[40], [95]], dtype=np.int32)
    arrs = (q, k, v, qpos, kpos)
    tq = _to_torch(arrs, BF16)
    assert fa.choose_tile(1, 96, 16, dtype=torch.bfloat16, groups=hq // hkv).path == "split"
    got = ops.flash_attention(*tq)
    g = hq // hkv
    per_head = ops.flash_attention(tq[0], tq[1].repeat_interleave(g, 2),
                                   tq[2].repeat_interleave(g, 2), tq[3], tq[4])
    np.testing.assert_allclose(_np(got), _np(per_head), atol=1e-6, rtol=1e-6)
    _check_all(arrs, BF16, pallas=False)


BF16_CASES = [
    # (B, Sq, Skv, Hq, Hkv, Dh, window, chunk, qpos): the fp32-only cases, now in bf16
    (2, 128, 128, 4, 2, 64, 16, None, None),
    (2, 128, 128, 4, 2, 64, None, 32, None),
    (2, 100, 100, 4, 2, 64, 32, None, None),
    (1, 70, 150, 4, 2, 256, None, None, None),
    (1, 5, 70, 2, 2, 64, None, None, -3),
    (4, 1, 64, 8, 2, 64, None, None, "unequal"),
    (2, 9, 100, 2, 2, 80, 24, None, None),
]


@pytest.mark.parametrize("case", BF16_CASES)
def test_bf16_paths_match_reference(case):
    """Each bf16 case through the path the chooser gives it (mma or split)."""
    *dims, window, chunk, qpos = case
    q, k, v, qp, kp = _inputs(*dims)
    if qpos == "unequal":
        qp = np.array([[3], [63], [17], [40]], dtype=np.int32)
    elif qpos is not None:
        qp = np.full_like(qp, qpos)
    _check_all((q, k, v, qp, kp), BF16, window=window, chunk=chunk, pallas=False)
