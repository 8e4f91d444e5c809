"""Training attention's plain forward and backward, and the chunked path's dispatch, on the CPU.

``repro_torch.kernels.train_attention`` holds the autograd function whose CUDA
kernels ``attention_chunked`` runs where autograd records a bfloat16 call on
the card, and the kernels' plain version, which CPU tensors run.  Here the
plain version (through the autograd function) is held in float32, at 2e-5,
against autograd through the chunked loop and against the JAX reference's
``jax.grad`` of its own chunked attention; inputs are made with numpy from a
seed and carried between the frameworks as numpy arrays.  The kernels
themselves are held against the plain version on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattention
from repro_torch import obs
from repro_torch.kernels import train_attention as ta
from repro_torch.models import attention

torch.set_num_threads(1)

TOL = 2e-5

#: (B, S, Hq, Hkv, Dh, window, chunk, kv_chunk, rows that see no key)
CASES = {
    "mha_dh80": (1, 96, 2, 2, 80, None, None, 32, ()),
    "gqa4_dh128": (2, 64, 8, 2, 128, None, None, 32, ()),
    "window": (2, 90, 4, 2, 32, 13, None, 32, ()),
    "chunk_mask": (1, 100, 4, 4, 16, None, 24, 32, ()),
    "ragged": (2, 100, 4, 2, 64, None, None, 64, ()),
    "row_sees_no_key": (1, 70, 2, 1, 48, None, None, 32, (3, 41)),
}


def _inputs(B, S, Hq, Hkv, Dh, empty_rows=(), seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, Hq, Dh), dtype=np.float32)
    k = rng.standard_normal((B, S, Hkv, Dh), dtype=np.float32)
    v = rng.standard_normal((B, S, Hkv, Dh), dtype=np.float32)
    do = rng.standard_normal((B, S, Hq, Dh), dtype=np.float32)
    kpos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S)).copy()
    qpos = kpos.copy()
    qpos[:, list(empty_rows)] = -3   # before every key: the row sees none
    return q, k, v, do, qpos, kpos


def _leaves(arrs):
    q, k, v, do, qpos, kpos = (torch.from_numpy(a) for a in arrs)
    return (q.requires_grad_(), k.requires_grad_(), v.requires_grad_(), do, qpos, kpos)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32),
                               np.asarray(want, dtype=np.float32), atol=tol, rtol=tol)


def _pad_keys(S, kv_chunk):
    return -(-S // kv_chunk) * kv_chunk


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_autograd_through_the_loop(case):
    B, S, Hq, Hkv, Dh, window, chunk, kv_chunk, empty = CASES[case]
    arrs = _inputs(B, S, Hq, Hkv, Dh, empty)
    q, k, v, do, qpos, kpos = _leaves(arrs)
    want = attention.attention_chunked(q, k, v, qpos, kpos, window, chunk, kv_chunk=kv_chunk)
    want_g = torch.autograd.grad(want, (q, k, v), do)
    before = dict(ta.train_attention.launches_by_kernel)
    got = ta.train_attention(q, k, v, qpos, kpos, window, chunk,
                             pad_keys=_pad_keys(S, kv_chunk))
    got_g = torch.autograd.grad(got, (q, k, v), do)
    assert ta.train_attention.launches_by_kernel == before   # the CPU runs no kernel
    _close(got.detach(), want.detach())
    for g, w in zip(got_g, want_g):
        _close(g, w)


def _jax_grads(arrs, window, chunk, kv_chunk):
    q, k, v, do, qpos, kpos = (jnp.asarray(a) for a in arrs)

    def loss(q, k, v):
        out = jattention.attention_chunked(q, k, v, qpos, kpos, window=window, chunk_attn=chunk,
                                           kv_chunk=kv_chunk)
        return jnp.sum(out * do)

    return jax.grad(loss, argnums=(0, 1, 2))(q, k, v)


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_the_jax_reference_gradient(case):
    B, S, Hq, Hkv, Dh, window, chunk, kv_chunk, empty = CASES[case]
    arrs = _inputs(B, S, Hq, Hkv, Dh, empty, seed=1)
    want = _jax_grads(arrs, window, chunk, kv_chunk)
    q, k, v, do, qpos, kpos = _leaves(arrs)
    out = ta.train_attention(q, k, v, qpos, kpos, window, chunk, pad_keys=_pad_keys(S, kv_chunk))
    got = torch.autograd.grad(out, (q, k, v), do)
    for g, w in zip(got, want):
        _close(g, np.asarray(w))


def test_plain_lse_and_the_mark_of_a_row_that_sees_no_key():
    """LSE is logsumexp over the visible scores; +inf marks a row that sees
    no key, whose output is the mean of the values over ``pad_keys``."""
    arrs = _inputs(1, 40, 2, 2, 16, empty_rows=(7,))
    q, k, v, _, qpos, kpos = (torch.from_numpy(a) for a in arrs)
    out, lse = ta.train_attention_plain_forward(q, k, v, qpos, kpos, pad_keys=64)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / 4.0
    s = torch.where(kpos[:, None, None, :] <= qpos[:, None, :, None], s, -torch.inf)
    want = torch.logsumexp(s, -1)
    assert torch.isinf(lse[:, :, 7]).all() and lse[:, :, 7].gt(0).all()
    live = torch.ones(40, dtype=torch.bool)
    live[7] = False
    _close(lse[:, :, live], want[:, :, live])
    _close(out[0, 7], (v.sum(1) / 64)[0])


def test_plain_bfloat16_rounds_p_and_ds_only():
    """In bfloat16 the plain version rounds P and dS before their products;
    its gradients stay within the bfloat16 rule of the float32 ones."""
    arrs = _inputs(1, 64, 4, 2, 32, seed=2)
    q, k, v, do, qpos, kpos = (torch.from_numpy(a) for a in arrs)
    bf = [t.bfloat16() for t in (q, k, v, do)]
    out32, lse32 = ta.train_attention_plain_forward(*bf[:3], qpos, kpos)
    out16, lse16 = ta.train_attention_plain_forward(*(t.float() for t in bf[:3]), qpos, kpos)
    assert out32.dtype == torch.bfloat16 and lse32.dtype == torch.float32
    _close(lse32, lse16)
    got = ta.train_attention_plain_backward(*bf[:3], out32, lse32, bf[3], qpos, kpos)
    want = ta.train_attention_plain_backward(*(t.float() for t in bf[:3]), out32.float(),
                                             lse32, bf[3].float(), qpos, kpos)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        _close(g.float(), w, 2e-2)


class _OnCard(torch.Tensor):
    """A CPU tensor that says it lies on the card: the dispatch's test alone."""

    @property
    def is_cuda(self):
        return True


def _qkv(dtype=torch.bfloat16, dh=80, grad=True):
    ts = [torch.zeros((1, 8, 2, dh), dtype=dtype).as_subclass(_OnCard) for _ in range(3)]
    return [t.requires_grad_(grad) for t in ts]


@pytest.mark.parametrize("why", ["cpu", "no_grad", "float32", "dh256", "inputs_need_no_grad"])
def test_chunked_dispatch_keeps_the_loop(why):
    assert attention.takes_train_kernel(*_qkv())
    if why == "cpu":
        q, k, v = (torch.zeros((1, 8, 2, 80), dtype=torch.bfloat16, requires_grad=True)
                   for _ in range(3))
        assert not attention.takes_train_kernel(q, k, v)
    elif why == "no_grad":
        with torch.no_grad():
            assert not attention.takes_train_kernel(*_qkv())
    elif why == "float32":
        assert not attention.takes_train_kernel(*_qkv(torch.float32))
    elif why == "dh256":
        assert not attention.takes_train_kernel(*_qkv(dh=256))
    else:
        assert not attention.takes_train_kernel(*_qkv(grad=False))


@pytest.fixture
def telemetry():
    obs.reset()
    obs.enable()
    try:
        yield obs.metrics()
    finally:
        obs.disable()
        obs.reset()


def _counts(reg):
    snap = reg.snapshot()
    return tuple(snap.get(name, 0) for name in ("attn.chunked_kernel_calls",
                                                "attn.chunked_loop_calls"))


def test_counters_count_the_loop(telemetry):
    q, k, v, do, qpos, kpos = _leaves(_inputs(1, 40, 2, 2, 16))
    attention.attention_chunked(q, k, v, qpos, kpos, kv_chunk=16)
    with torch.no_grad():
        attention.attention_chunked(q, k, v, qpos, kpos, kv_chunk=16)
    assert _counts(telemetry) == (0, 2)


def test_counters_count_the_kernel_path_and_it_pads_as_the_loop(telemetry, monkeypatch):
    """With the dispatch's test forced true on the CPU the call goes through
    ``train_attention`` (its plain version here): the kernel path's counter
    counts it, and its ``pad_keys`` is the loop's padded key count."""
    arrs = _inputs(1, 50, 2, 2, 16, empty_rows=(9,))
    q, k, v, do, qpos, kpos = _leaves(arrs)
    want = attention.attention_chunked(q, k, v, qpos, kpos, kv_chunk=16)
    want_g = torch.autograd.grad(want, (q, k, v), do)
    monkeypatch.setattr(attention, "takes_train_kernel", lambda *a: True)
    got = attention.attention_chunked(q, k, v, qpos, kpos, kv_chunk=16)
    got_g = torch.autograd.grad(got, (q, k, v), do)
    assert _counts(telemetry) == (1, 1)
    _close(got.detach(), want.detach())
    for g, w in zip(got_g, want_g):
        _close(g, w)


def test_wrapper_refuses_what_it_does_not_take():
    q, k, v, _, qpos, kpos = (torch.from_numpy(a) for a in _inputs(1, 8, 4, 2, 16))
    three = torch.zeros((1, 8, 3, 16))
    with pytest.raises(ValueError, match="multiple"):
        ta.train_attention(q, three, three, qpos, kpos)
    with pytest.raises(ValueError, match="positions"):
        ta.train_attention(q, k, v, qpos[:, :4], kpos)
    with pytest.raises(TypeError, match="integer"):
        ta.train_attention(q, k, v, qpos.float(), kpos)
    with pytest.raises(TypeError, match="share a dtype"):
        ta.train_attention(q, k.double(), v, qpos, kpos)


@pytest.mark.parametrize("dh", [16, 64, 80, 96, 128])
def test_kernels_shared_memory_fits_a_block(dh):
    """Every kernel's block fits the 227 KB an H100 block may take, at
    4,096 tokens and at 32,768 with eight query heads a kv head."""
    for sq, groups in ((4096, 1), (32768, 8)):
        for kernel in ("fwd", "bwd_dkdv", "bwd_dq"):
            assert ta.smem_bytes(kernel, dh, sq, sq, groups) <= 227 * 1024
    assert ta.takes_head_dim(dh) and not ta.takes_head_dim(dh + 8) and not ta.takes_head_dim(256)
