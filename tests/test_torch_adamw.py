"""AdamW's CUDA kernels (``repro_torch.kernels.adamw``) and their plain version.

This file imports neither JAX nor the JAX package: the plain version is held
to the JAX reference in ``test_torch_train.py``.  Here, on the CPU: the plain
version against a frozen copy of the port's update as it was before the
kernels (bit for bit), the CPU and ``meta`` paths launching nothing, the
counters registered, and the kernels' input checks.  On the card (``pytest
-m gpu``; each test skips without one): the kernels against the plain
version over three steps on every stablelm_3b leaf shape with the layer axis
cut to 2, in bfloat16 and float32, the norm given or computed, the clip
engaged or not; the launches; what raises; the norm the same bits twice.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels import adamw as kadamw
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, cosine_schedule, global_norm

NO_CARD = "no CUDA device: the CUDA kernel has no interpret mode"


# ---------------------------------------------------------------------------
# the port's update as it was before the kernels, frozen
# ---------------------------------------------------------------------------


def _frozen_f32(x, device):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def frozen_global_norm(tree):
    total = None
    for x in tree.values():
        sq = x.float().square().sum()
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def frozen_adamw_update(cfg, params, grads, state, grad_norm=None):
    count = state["count"] + 1
    dev = count.device
    lr = cosine_schedule(cfg, count)
    gnorm = frozen_global_norm(grads) if grad_norm is None else grad_norm
    scale = torch.minimum(_frozen_f32(1.0, dev),
                          cfg.grad_clip / torch.clamp_min(gnorm, 1e-9))
    c = count.to(torch.float32)
    bias1 = 1 - _frozen_f32(cfg.b1, dev) ** c
    bias2 = 1 - _frozen_f32(cfg.b2, dev) ** c
    for k, p in params.items():
        mu, nu = state["mu"][k], state["nu"][k]
        g = grads[k].float() * scale
        mu.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
        nu.mul_(cfg.b2).add_(g.square_(), alpha=1 - cfg.b2)
        del g
        step = (mu / bias1).div_((nu / bias2).sqrt_().add_(cfg.eps))
        p32 = p.float()
        step.add_(p32, alpha=cfg.weight_decay).mul_(lr)
        p.copy_(p32.sub_(step))
        del step, p32
    return params, {"mu": state["mu"], "nu": state["nu"], "count": count}, \
        {"grad_norm": gnorm, "lr": lr}


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------

#: small CPU leaves: a matrix, a vector, a stacked 3-d leaf, a tail that no
#: 8-element vector covers, one element
CPU_SHAPES = {"w": (33, 17), "b": (17,), "stack": (2, 9, 40), "odd": (1001,), "one": (1,)}
OPT = AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=5)


def _cpu_tree(seed, p_dtype, g_dtype, g_std):
    rng = np.random.default_rng(seed)
    params = {k: torch.from_numpy((rng.standard_normal(s) * 0.02).astype(np.float32)).to(p_dtype)
              for k, s in CPU_SHAPES.items()}
    grads = [{k: torch.from_numpy((rng.standard_normal(s) * g_std).astype(np.float32)).to(g_dtype)
              for k, s in CPU_SHAPES.items()} for _ in range(3)]
    return params, grads


def _copy(tree):
    return {k: t.clone() for k, t in tree.items()}


CPU_CASES = {
    "bf16_params_bf16_grads_clipped": (0, torch.bfloat16, torch.bfloat16, 1.0, False),
    "bf16_params_fp32_grads_unclipped": (1, torch.bfloat16, torch.float32, 1e-3, False),
    "fp32_params_fp32_grads_clipped": (2, torch.float32, torch.float32, 1.0, False),
    "fp32_params_bf16_grads_norm_given": (3, torch.float32, torch.bfloat16, 1.0, True),
    "bf16_params_fp32_grads_norm_given": (4, torch.bfloat16, torch.float32, 1e-3, True),
}


@pytest.mark.parametrize("case", CPU_CASES)
def test_plain_version_equals_the_update_before_the_kernels_bit_for_bit(case):
    """``adamw_update`` on CPU tensors (the plain version) against the frozen
    pre-kernel update: three steps, parameters, moments, count, norm and rate
    the same bits."""
    seed, p_dtype, g_dtype, g_std, given = CPU_CASES[case]
    params, grads = _cpu_tree(seed, p_dtype, g_dtype, g_std)
    mine, theirs = _copy(params), _copy(params)
    state, frozen = adamw_init(mine), adamw_init(theirs)
    for step in grads:
        norm = torch.tensor(0.75 + 0.5 * seed, dtype=torch.float32) if given else None
        _, state, met = adamw_update(OPT, mine, step, state, grad_norm=norm)
        _, frozen, want = frozen_adamw_update(OPT, theirs, _copy(step), frozen, grad_norm=norm)
        for k in params:
            assert torch.equal(mine[k], theirs[k]), k
            assert torch.equal(state["mu"][k], frozen["mu"][k]), k
            assert torch.equal(state["nu"][k], frozen["nu"][k]), k
        assert torch.equal(state["count"], frozen["count"])
        assert torch.equal(met["grad_norm"], want["grad_norm"])
        assert torch.equal(met["lr"], want["lr"])


@pytest.mark.parametrize("g_dtype", [torch.float32, torch.bfloat16])
def test_plain_global_norm_equals_the_norm_before_the_kernels(g_dtype):
    _, grads = _cpu_tree(7, torch.float32, g_dtype, 1.0)
    assert torch.equal(global_norm(grads[0]), frozen_global_norm(grads[0]))
    assert torch.equal(kadamw.global_norm_plain(grads[0]), frozen_global_norm(grads[0]))


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_update_off_the_card_launches_no_kernel(device):
    """CPU tensors (the tests) and ``meta`` tensors (the dry-run) take the
    plain version: the kernels' counters stay where they were."""
    params, grads = _cpu_tree(0, torch.bfloat16, torch.bfloat16, 1.0)
    params = {k: p.to(device) for k, p in params.items()}
    step = {k: g.to(device) for k, g in grads[0].items()}
    before = dict(kadamw.adamw.launches_by_kernel)
    _, state, met = adamw_update(OPT, params, step, adamw_init(params))
    global_norm(step)
    assert kadamw.adamw.launches_by_kernel == before
    assert met["grad_norm"].device.type == device and state["count"].device.type == device


def test_adamw_is_a_counted_wrapper():
    """``kernels.COUNTED`` holds the wrapper, and ``launch_counts`` lists both
    of its counters."""
    wrapper, counters = kernels.COUNTED["adamw"]
    assert wrapper is kadamw.adamw and counters == ("launches_by_kernel",)
    counts = kernels.launch_counts()
    assert {key for (name, _, key) in counts if name == "adamw"} == set(kadamw.KERNELS)
    assert kadamw.KERNELS == ("norm", "update")


def _leaf_case(bad):
    """One leaf with one fault, as ``adamw`` would be handed it."""
    p = torch.zeros(4, 8, dtype=torch.bfloat16)
    g = torch.zeros(4, 8, dtype=torch.bfloat16)
    mu, nu = torch.zeros(4, 8), torch.zeros(4, 8)
    if bad == "non_contiguous_grad":
        g = torch.zeros(8, 4, dtype=torch.bfloat16).t()
    elif bad == "non_contiguous_param":
        p = torch.zeros(8, 4, dtype=torch.bfloat16).t()
    elif bad == "element_count":
        nu = torch.zeros(4, 9)
    elif bad == "fp16_moment":
        mu = mu.half()
    elif bad == "fp16_param":
        p = p.half()
    elif bad == "int_grad":
        g = g.to(torch.int32)
    return p, g, mu, nu


CHECK_ERRORS = {"non_contiguous_grad": ValueError, "non_contiguous_param": ValueError,
                "element_count": ValueError, "fp16_moment": TypeError, "fp16_param": TypeError,
                "int_grad": TypeError}


@pytest.mark.parametrize("bad", CHECK_ERRORS)
def test_kernel_input_checks_refuse(bad):
    """What the kernels refuse (the checks themselves; on the card ``adamw``
    runs them on every leaf before any launch)."""
    p, g, mu, nu = _leaf_case(bad)
    n = p.numel()
    with pytest.raises(CHECK_ERRORS[bad]):
        for name, t, dtypes in (("param", p, kadamw._DTYPES), ("grad", g, kadamw._DTYPES),
                                ("mu", mu, (torch.float32,)), ("nu", nu, (torch.float32,))):
            kadamw._check(name, t, dtypes, n, p.device)


def test_mixed_devices_refused():
    with pytest.raises(ValueError):
        kadamw._on_card({"a": torch.zeros(1), "b": torch.zeros(1, device="meta")})


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

#: the card's steps (the leaves, the gaps and their limits are ``chip_smoke``'s
#: ``adamw_shapes``, ``adamw_gaps`` and ``ADAMW_LIMITS``, its ``adamw`` line's)
CARD_OPT = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
#: stablelm_3b's leaves at its published widths, the layer axis cut to 2
CARD_LAYERS = 2
#: the gradients' scale: the global norm well above 1 (clipped) or below it
GRAD_STD = {"clipped": 1e-3, "unclipped": 1e-5}


def _smoke():
    import chip_smoke

    return chip_smoke


def _draw(shapes, std, dtype, gen):
    return {k: (torch.randn(s, generator=gen, device="cuda") * std).to(dtype)
            for k, s in shapes.items()}


def _step_gaps(smoke, params, state, met, plain, pstate, pnorm, before):
    return smoke.adamw_gaps(
        {"params": params, "mu": state["mu"], "nu": state["nu"], "grad_norm": met["grad_norm"]},
        {"params": plain, "mu": pstate["mu"], "nu": pstate["nu"], "grad_norm": pnorm}, before)


CARD_CASES = {f"p_{p}-g_{g}-{norm}-{clip}": (p, g, norm, clip)
              for p in ("bf16", "fp32") for g in ("bf16", "fp32")
              for norm in ("computed", "given") for clip in ("clipped", "unclipped")}
DTYPE = {"bf16": torch.bfloat16, "fp32": torch.float32}


@pytest.mark.gpu
@pytest.mark.parametrize("case", CARD_CASES)
def test_adamw_kernels_match_plain_on_the_card(case):
    """Three steps of the kernels and of the plain version, each from the
    same parameters, moments and gradients (the kernel's side is set to the
    plain version's after each comparison, so that one step's roundings do
    not compound into the next), every stablelm_3b leaf shape (the layer axis
    cut to 2): the moments, the norm and the parameters within
    ``chip_smoke.ADAMW_LIMITS``."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    smoke = _smoke()
    p_name, g_name, norm, clip = CARD_CASES[case]
    shapes = smoke.adamw_shapes(CARD_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(sorted(CARD_CASES).index(case))
    params = _draw(shapes, 0.02, DTYPE[p_name], gen)
    plain = _copy(params)
    state, pstate = adamw_init(params), adamw_init(plain)
    for _ in range(3):
        grads = _draw(shapes, GRAD_STD[clip], DTYPE[g_name], gen)
        given = kadamw.global_norm_plain(grads) if norm == "given" else None
        before = _copy(plain)
        _, state, met = adamw_update(CARD_OPT, params, grads, state, grad_norm=given)
        pstate, pnorm = smoke.adamw_plain_step(CARD_OPT, plain, grads, pstate, given)
        gaps, faults = _step_gaps(smoke, params, state, met, plain, pstate, pnorm, before)
        assert not faults, (faults, gaps)
        assert (float(pnorm) > 1.0) == (clip == "clipped"), float(pnorm)
        assert torch.equal(state["count"], pstate["count"])
        smoke.adamw_resync(params, state, plain, pstate)


@pytest.mark.gpu
def test_adamw_kernels_take_many_odd_leaves_on_the_card():
    """More leaves than one launch takes, sizes off the 8-element vectors and
    the 4,096-element tiles, one leaf off a 16-byte boundary (a contiguous
    view at an offset): the same gaps, and the launches each table makes."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    smoke = _smoke()
    sizes = [1, 7, 8, 4095, 4096, 4097, 8191, 12345] * 5
    gen = torch.Generator(device="cuda").manual_seed(11)
    params = {f"l{i}": torch.randn(n, generator=gen, device="cuda").mul_(0.02).bfloat16()
              for i, n in enumerate(sizes)}
    base = torch.empty(4097 + 1, dtype=torch.bfloat16, device="cuda")
    params["offset"] = base[1:].copy_(torch.randn(4097, generator=gen, device="cuda") * 0.02)
    assert params["offset"].data_ptr() % 16 != 0 and params["offset"].is_contiguous()
    plain = _copy(params)
    state, pstate = adamw_init(params), adamw_init(plain)
    tables = math.ceil(len(params) / 32)   # leaves a launch: kMaxLeaves, csrc/adamw.cu
    for _ in range(3):
        grads = {k: torch.randn(p.shape, generator=gen, device="cuda").bfloat16()
                 for k, p in params.items()}
        counts, before = dict(kadamw.adamw.launches_by_kernel), _copy(plain)
        _, state, met = adamw_update(CARD_OPT, params, grads, state)
        after = kadamw.adamw.launches_by_kernel
        assert after == {"norm": counts["norm"] + tables + 1, "update": counts["update"] + tables}
        pstate, pnorm = smoke.adamw_plain_step(CARD_OPT, plain, grads, pstate, None)
        gaps, faults = _step_gaps(smoke, params, state, met, plain, pstate, pnorm, before)
        assert not faults, (faults, gaps)
        smoke.adamw_resync(params, state, plain, pstate)


@pytest.mark.gpu
def test_adamw_on_the_card_runs_only_the_kernels(monkeypatch):
    """A CUDA call raises the counters (the norm's two launches and one
    update for stablelm_3b's 12 leaves; no norm when it is given) and never
    calls the plain version."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)

    def refused(*args, **kw):
        raise AssertionError("the plain version ran on the card")

    monkeypatch.setattr(kadamw, "adamw_plain", refused)
    monkeypatch.setattr(kadamw, "global_norm_plain", refused)
    shapes = _smoke().adamw_shapes(CARD_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(3)
    params = _draw(shapes, 0.02, torch.bfloat16, gen)
    grads = _draw(shapes, 1e-3, torch.bfloat16, gen)
    state = adamw_init(params)
    before = dict(kadamw.adamw.launches_by_kernel)
    _, state, met = adamw_update(CARD_OPT, params, grads, state)
    assert kadamw.adamw.launches_by_kernel == {"norm": before["norm"] + 2,
                                               "update": before["update"] + 1}
    _, state, _ = adamw_update(CARD_OPT, params, grads, state, grad_norm=met["grad_norm"])
    assert kadamw.adamw.launches_by_kernel == {"norm": before["norm"] + 2,
                                               "update": before["update"] + 2}
    global_norm(grads)
    torch.cuda.synchronize()
    assert kadamw.adamw.launches_by_kernel["norm"] == before["norm"] + 4


@pytest.mark.gpu
@pytest.mark.parametrize("bad", CHECK_ERRORS)
def test_adamw_kernels_refuse_on_the_card(bad):
    """Non-contiguous leaves, mismatched element counts, half-precision
    moments or parameters and integer gradients raise before any launch."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    p, g, mu, nu = (t.cuda() for t in _leaf_case(bad))
    if bad.startswith("non_contiguous"):      # .cuda() keeps the strides
        assert not (p.is_contiguous() and g.is_contiguous())
    before = dict(kadamw.adamw.launches_by_kernel)
    count = torch.ones((), dtype=torch.int32, device="cuda")
    lr = torch.full((), 1e-3, device="cuda")
    with pytest.raises(CHECK_ERRORS[bad]):
        kadamw.adamw(CARD_OPT, {"w": p}, {"w": g}, {"w": mu}, {"w": nu}, count, lr)
    assert kadamw.adamw.launches_by_kernel == before


@pytest.mark.gpu
def test_adamw_norm_is_the_same_bits_twice_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    gen = torch.Generator(device="cuda").manual_seed(5)
    smoke = _smoke()
    grads = _draw(smoke.adamw_shapes(CARD_LAYERS), 1e-3, torch.bfloat16, gen)
    first, second = global_norm(grads), global_norm(grads)
    assert torch.equal(first, second)
    plain = kadamw.global_norm_plain(grads)
    assert abs(float(first) - float(plain)) <= smoke.ADAMW_LIMITS["norm_rtol"] * float(plain)
