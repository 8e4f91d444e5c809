"""The port's SSD kernel module against the JAX package, on the CPU.

The same inputs, made with numpy from a seed, go through
``repro.kernels.ops.mamba2_ssd`` (the Pallas kernel in interpret mode),
``repro.kernels.ref.ssd_reference`` and ``repro.models.mamba2.ssd_chunked`` on
one side, and through the port's ``mamba2_ssd`` wrapper (which on CPU tensors
runs the kernel's plain PyTorch version) and the port's oracle on the other.
Tolerances are the reference's own: 2e-4 in float32 against the oracle and the
Pallas kernel, 5e-2 in bfloat16, 1e-4 against ``ssd_chunked``, 1e-5 between
two p-splits.  The CUDA kernel itself is held against the plain version on
the GPU by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.mamba2 import ssd_chunked as jssd_chunked
from repro_torch.kernels import mamba2_ssd as ssd
from repro_torch.kernels import ops, ref

torch.set_num_threads(1)

SSD_SHAPES = [
    # (B, S, H, P, N, chunk) — the sweep of tests/test_kernels.py
    (1, 64, 2, 16, 16, 16),
    (2, 128, 4, 32, 32, 32),
    (1, 96, 8, 16, 64, 32),
    (2, 64, 4, 64, 16, 16),
]


def _inputs(B, S, H, P, N, seed=0):
    """x, dt (post-softplus), a (negative), bm, cm as float32 numpy arrays,
    drawn as the reference's tests draw them."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, S, H, P)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    a = (-np.exp(rng.standard_normal(H) * 0.3)).astype(np.float32)
    bm = (rng.standard_normal((B, S, N)) * 0.4).astype(np.float32)
    cm = (rng.standard_normal((B, S, N)) * 0.4).astype(np.float32)
    return x, dt, a, bm, cm


def _h0(B, H, P, N, seed=5):
    return (np.random.default_rng(seed).standard_normal((B, H, P, N)) * 0.3).astype(np.float32)


def _torch(arrs, dtype=torch.float32, dt_dtype=torch.float32):
    x, dt, a, bm, cm = (torch.from_numpy(v) for v in arrs)
    return x.to(dtype), dt.to(dt_dtype), a, bm.to(dtype), cm.to(dtype)


def _jax(arrs, dtype=jnp.float32, dt_dtype=jnp.float32):
    x, dt, a, bm, cm = (jnp.asarray(v) for v in arrs)
    return x.astype(dtype), dt.astype(dt_dtype), a, bm.astype(dtype), cm.astype(dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# The plain version against the reference kernel, oracle and scan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", SSD_SHAPES)
def test_ssd_shapes_match_pallas_and_oracle(shape):
    B, S, H, P, N, chunk = shape
    arrs = _inputs(B, S, H, P, N)
    before = ssd.mamba2_ssd.launches
    y, h = ops.mamba2_ssd(*_torch(arrs))
    assert ssd.mamba2_ssd.launches == before, "a CPU tensor must not count as a launch"
    assert y.shape == (B, S, H, P) and y.dtype == torch.float32
    assert h.shape == (B, H, P, N) and h.dtype == torch.float32
    yk, hk = jops.mamba2_ssd(*_jax(arrs), chunk=chunk)
    yr, hr = jref.ssd_reference(*_jax(arrs))
    for got, want in ((y, yk), (h, hk), (y, yr), (h, hr)):
        _close(got, want, 2e-4)


@pytest.mark.parametrize("dt_dtype", ["float32", "bfloat16"])
def test_ssd_bf16(dt_dtype):
    """bfloat16 x, B, C (and dt, as tests/test_kernels.py::test_ssd_kernel_bf16
    feeds it): y comes out in bfloat16."""
    arrs = _inputs(1, 64, 4, 16, 32)
    tdt = getattr(torch, dt_dtype)
    y, h = ops.mamba2_ssd(*_torch(arrs, torch.bfloat16, tdt))
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    jx = _jax(arrs, jnp.bfloat16, getattr(jnp, dt_dtype))
    yk, _ = jops.mamba2_ssd(*jx, chunk=16)
    yr, hr = jref.ssd_reference(*jx)
    _close(y, yr, 5e-2)
    _close(y, yk, 5e-2)
    _close(h, hr, 5e-2)


def test_ssd_matches_model_scan_path():
    """The plain version agrees with the reference model's chunked dual form."""
    arrs = _inputs(2, 64, 4, 16, 32)
    y, h = ops.mamba2_ssd(*_torch(arrs))
    x, dt, a, bm, cm = _jax(arrs)
    ym, hm = jssd_chunked(x, dt, a, bm[:, :, None, :], cm[:, :, None, :], chunk=16)
    _close(y, ym, 1e-4)
    _close(h, hm, 1e-4)


@pytest.mark.parametrize("S", [1, 3, 63, 65, 100, 200])
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_ragged_lengths_and_initial_state(S, with_h0):
    """Any S (the kernel's 64-row chunk, and the reference's 256, need not
    divide it) and an initial state, against ssd_chunked, which has both."""
    B, H, P, N = 2, 3, 16, 32
    arrs = _inputs(B, S, H, P, N, seed=S)
    h0 = _h0(B, H, P, N) if with_h0 else None
    y, h = ops.mamba2_ssd(*_torch(arrs), h0=None if h0 is None else torch.from_numpy(h0))
    x, dt, a, bm, cm = _jax(arrs)
    ym, hm = jssd_chunked(x, dt, a, bm[:, :, None, :], cm[:, :, None, :], chunk=256,
                          h0=None if h0 is None else jnp.asarray(h0))
    _close(y, ym, 1e-4)
    _close(h, hm, 1e-4)
    # the port's oracle takes h0 too, and agrees with both
    yr, hr = ref.ssd_reference(*_torch(arrs), h0=None if h0 is None else torch.from_numpy(h0))
    _close(yr, ym, 1e-4)
    _close(hr, hm, 1e-4)


@pytest.mark.parametrize("shape", SSD_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_reference_matches_jax(shape, dtype):
    B, S, H, P, N, _ = shape
    arrs = _inputs(B, S, H, P, N, seed=7)
    got_y, got_h = ref.ssd_reference(*_torch(arrs, getattr(torch, dtype)))
    want_y, want_h = jref.ssd_reference(*_jax(arrs, getattr(jnp, dtype)))
    assert got_y.dtype == getattr(torch, dtype)
    tol = 2e-5 if dtype == "float32" else 2e-2
    _close(got_y, want_y, tol)
    _close(got_h, want_h, tol)


@pytest.mark.parametrize("p_block", [16, 32, 64])
def test_ssd_p_block_invariant(p_block):
    """The state rows a block owns must not change the result (the
    counterpart of test_ssd_head_blocking_invariant)."""
    arrs = _inputs(1, 130, 4, 64, 16)
    base_y, base_h = ops.mamba2_ssd(*_torch(arrs), p_block=16)
    y, h = ops.mamba2_ssd(*_torch(arrs), p_block=p_block)
    _close(y, base_y, 1e-5)
    _close(h, base_h, 1e-5)


def test_ssd_out_dtype_and_strided_views():
    """The model's call: x, B and C column slices of one bfloat16 tensor, y
    asked for in float32 — no rounding of y before the layer's own."""
    B, S, H, P, N = 2, 70, 4, 16, 32
    x, dt, a, bm, cm = _torch(_inputs(B, S, H, P, N))
    xbc = torch.cat([x.reshape(B, S, H * P), bm, cm], dim=-1).bfloat16()
    xs = xbc[..., :H * P].reshape(B, S, H, P)
    bv, cv = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
    assert not xs.is_contiguous() and xs.stride(-1) == 1
    y32, h32 = ops.mamba2_ssd(xs, dt, a, bv, cv, out_dtype=torch.float32)
    y16, h16 = ops.mamba2_ssd(xs, dt, a, bv, cv)
    assert y32.dtype == torch.float32 and y16.dtype == torch.bfloat16
    assert torch.equal(y32.bfloat16(), y16) and torch.equal(h32, h16)
    want_y, want_h = ssd.ssd_plain(xs.contiguous().float(), dt, a, bv.float(), cv.float())
    assert torch.equal(y32, want_y) and torch.equal(h32, want_h)


def test_plain_version_walks_64_row_chunks():
    """The plain version is the kernel's arithmetic: a sequence split at the
    chunk boundary, the second half started from the first half's state,
    gives the same numbers bit for bit."""
    arrs = _torch(_inputs(1, 2 * ssd.CHUNK + 9, 2, 16, 16))
    y, h = ssd.ssd_plain(*arrs)
    cut = ssd.CHUNK
    first = [t[:, :cut] for t in (arrs[0], arrs[1])] + [arrs[2]] + [t[:, :cut] for t in arrs[3:]]
    rest = [t[:, cut:] for t in (arrs[0], arrs[1])] + [arrs[2]] + [t[:, cut:] for t in arrs[3:]]
    y1, h1 = ssd.ssd_plain(*first)
    y2, h2 = ssd.ssd_plain(*rest, h0=h1)
    assert torch.equal(torch.cat([y1, y2], dim=1), y) and torch.equal(h2, h)


# ---------------------------------------------------------------------------
# What the kernel takes, and what the wrapper refuses
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("path", ssd.PATHS)
@pytest.mark.parametrize("n", ssd.STATE_WIDTHS)
@pytest.mark.parametrize("ps", ssd.P_BLOCKS)
def test_every_instantiation_fits_a_block(path, n, ps):
    """Every (path, N, p_block) the kernel is built for fits a block's shared
    memory and a thread's 255 registers, and an SM holds at least one block."""
    assert ssd.smem_bytes(n, ps, path) <= 227 * 1024
    assert 0 < ssd.REGISTERS[(path, n, ps)] <= 255
    assert ssd.resident_blocks(n, ps, path) >= 1
    if path == "fma":
        assert ps * n % ssd.THREADS == 0    # the state splits evenly over the threads
    else:
        assert ps % 16 == 0 and n % 16 == 0  # h is cut into 16 x 16 mma tiles


#: the main path's calls: one prompt through each model's mamba layers
MAIN_SHAPES = {"mamba2_370m": (1, 32, 64, 128), "zamba2_2_7b": (1, 80, 64, 64)}


@pytest.mark.parametrize("model", sorted(MAIN_SHAPES))
def test_main_path_shapes_pick_mma_and_one_wave(model):
    """The grid runs in one wave of resident blocks: no SM runs two blocks of
    the call one after the other."""
    B, H, P, N = MAIN_SHAPES[model]
    plan = ssd.choose_plan(B, H, P, N, torch.bfloat16)
    assert plan.path == "mma" and plan.threads == ssd.THREADS
    assert plan.blocks == B * H * (P // plan.p_block)
    assert plan.smem_bytes == ssd.smem_bytes(N, plan.p_block, "mma") <= ssd.SMEM_PER_BLOCK
    assert plan.resident >= 1 and plan.waves == 1
    assert plan.blocks <= ssd.SMS * plan.resident


def test_main_path_plans():
    """The chooser's picks at the main path's shapes: every split of
    mamba2_370m's heads runs in one wave, so the fewest state rows a block
    (128 blocks, one an SM); zamba2_2_7b's narrow state lets an SM hold two
    blocks, so 32 rows (160 blocks) run in one wave and 16 rows (320) in two."""
    assert ssd.choose_plan(1, 32, 64, 128, torch.bfloat16).p_block == 16
    plan = ssd.choose_plan(1, 80, 64, 64, torch.bfloat16)
    assert (plan.p_block, plan.resident, plan.waves) == (32, 2, 1)
    assert ssd.choose_plan(1, 80, 64, 64, torch.bfloat16, p_block=16).waves == 2
    # more prompts than one wave holds: the fewest waves
    plan = ssd.choose_plan(8, 32, 64, 128, torch.bfloat16)
    assert (plan.p_block, plan.waves) == (64, 2)


@pytest.mark.parametrize("shape", [(1, 32, 64, 128), (1, 80, 64, 64), (2, 4, 32, 16)])
def test_fp32_picks_fma(shape):
    plan = ssd.choose_plan(*shape, torch.float32)
    assert plan.path == "fma" and plan.threads == ssd.THREADS
    assert plan.smem_bytes == ssd.smem_bytes(shape[3], plan.p_block, "fma")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ps", ssd.P_BLOCKS)
def test_explicit_p_block_overrides(dtype, ps):
    plan = ssd.choose_plan(1, 32, 64, 128, getattr(torch, dtype), p_block=ps)
    assert plan.p_block == ps and plan.blocks == 32 * 64 // ps
    assert plan.path == ("mma" if dtype == "bfloat16" else "fma")
    # the chooser is deterministic
    assert plan == ssd.choose_plan(1, 32, 64, 128, getattr(torch, dtype), p_block=ps)


@pytest.mark.parametrize("path", ssd.PATHS)
def test_smem_bytes_is_the_kernels_formula(path):
    """The kernel's own formulas (csrc/mamba2_ssd.cu: smem_floats,
    mma_smem_bytes), written out; chip_smoke.py's build phase checks the
    compiled ones through repro_mamba2_ssd_smem_bytes."""
    for n in ssd.STATE_WIDTHS:
        for ps in ssd.P_BLOCKS:
            if path == "fma":
                want = 4 * (2 * 64 * (n + 1) + 64 * 65 + 2 * 64 * ps + ps * (n + 1) + 256)
            else:
                stage = 2 * 64 * (n + 8) * 2 + 64 * (ps + 8) * 2 + 64 * 4
                want = 2 * stage + 4 * ps * (n + 8) * 2 + 64 * ps * 4 + 8 * 3 * 64 * 4
            assert ssd.smem_bytes(n, ps, path) == want
    assert ssd.smem_bytes(128, 16, "fma") == 4 * (2 * 64 * 129 + 64 * 65 + 2 * 64 * 16 + 16 * 129 + 256)
    assert ssd.smem_bytes(128, 16, "mma") == 95744 + 64 * 16 * 4 + 4096


def test_plan_refuses_what_the_kernel_is_not_built_for():
    with pytest.raises(ValueError):
        ssd.choose_plan(1, 2, 24, 32, torch.float32)
    with pytest.raises(ValueError):
        ssd.choose_plan(1, 2, 32, 24, torch.bfloat16)
    with pytest.raises(ValueError):
        ssd.choose_plan(1, 2, 32, 32, torch.bfloat16, p_block=64)
    with pytest.raises(ValueError):
        ssd.smem_bytes(32, 16, "wgmma")


def test_a_cpu_call_counts_no_launch_on_any_path():
    x, dt, a, bm, cm = _torch(_inputs(1, 70, 2, 32, 32), torch.bfloat16)
    before = (ssd.mamba2_ssd.launches, dict(ssd.mamba2_ssd.launches_by_path))
    ops.mamba2_ssd(x, dt, a, bm, cm, out_dtype=torch.float32)
    assert (ssd.mamba2_ssd.launches, ssd.mamba2_ssd.launches_by_path) == before
    assert set(ssd.mamba2_ssd.launches_by_path) == set(ssd.PATHS)


def _refusals():
    x, dt, a, bm, cm = _torch(_inputs(1, 8, 2, 32, 32))
    return {
        "fp16": (lambda: ops.mamba2_ssd(x.half(), dt, a, bm.half(), cm.half()), TypeError),
        "mixed x / bm": (lambda: ops.mamba2_ssd(x, dt, a, bm.bfloat16(), cm.bfloat16()), TypeError),
        "fp16 dt": (lambda: ops.mamba2_ssd(x, dt.half(), a, bm, cm), TypeError),
        "bf16 h0": (lambda: ops.mamba2_ssd(x, dt, a, bm, cm,
                                           h0=torch.zeros(1, 2, 32, 32, dtype=torch.bfloat16)),
                    TypeError),
        "y below x's precision": (lambda: ops.mamba2_ssd(x, dt, a, bm, cm,
                                                         out_dtype=torch.bfloat16), TypeError),
        "N = 24": (lambda: ops.mamba2_ssd(x, dt, a, bm[..., :24], cm[..., :24]), ValueError),
        "N = 256": (lambda: ops.mamba2_ssd(x, dt, a, bm.repeat(1, 1, 8), cm.repeat(1, 1, 8)),
                    ValueError),
        "P = 24": (lambda: ops.mamba2_ssd(x[..., :24], dt, a, bm, cm), ValueError),
        "p_block 128": (lambda: ops.mamba2_ssd(x, dt, a, bm, cm, p_block=128), ValueError),
        "p_block 64 > P": (lambda: ops.mamba2_ssd(x, dt, a, bm, cm, p_block=64), ValueError),
        "shapes": (lambda: ops.mamba2_ssd(x, dt[:, :4], a, bm, cm), ValueError),
        "h0 shape": (lambda: ops.mamba2_ssd(x, dt, a, bm, cm, h0=torch.zeros(1, 2, 32, 16)),
                     ValueError),
        "empty": (lambda: ops.mamba2_ssd(x[:, :0], dt[:, :0], a, bm[:, :0], cm[:, :0]),
                  ValueError),
        "grad": (lambda: ops.mamba2_ssd(x.clone().requires_grad_(), dt, a, bm, cm), RuntimeError),
    }


@pytest.mark.parametrize("case", sorted(_refusals()))
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    call, exc = _refusals()[case]
    before = ssd.mamba2_ssd.launches
    with pytest.raises(exc):
        call()
    assert ssd.mamba2_ssd.launches == before


def test_forward_only_under_no_grad_is_fine():
    x, dt, a, bm, cm = _torch(_inputs(1, 8, 2, 16, 16))
    with torch.no_grad():
        y, _ = ops.mamba2_ssd(x.clone().requires_grad_(), dt, a, bm, cm)
    assert torch.isfinite(y).all()


def test_a_cuda_tensor_never_reaches_the_plain_version():
    """The wrapper picks the plain version by the tensor's device alone: any
    other device takes the kernel path or raises — it does not fall back."""
    import pathlib

    src = (pathlib.Path(ssd.__file__)).read_text()
    body = src[src.index("def mamba2_ssd("):]
    assert "try:" not in body and "except" not in body
    assert body.count("ssd_plain(") == 1
    assert body.index('x.device.type == "cpu"') < body.index("ssd_plain(")
    x, dt, a, bm, cm = (t.to("meta") for t in _torch(_inputs(1, 8, 2, 16, 16)))
    before = ssd.mamba2_ssd.launches
    with pytest.raises(RuntimeError, match="cuda or cpu"):
        ssd.mamba2_ssd(x, dt, a, bm, cm)
    assert ssd.mamba2_ssd.launches == before
