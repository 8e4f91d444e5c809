"""The port's framework-level RegDem layer: residency planner + selector.

``tests/test_tpu_adaptation.py``'s cases, one for one, on
``repro_torch.core.vmem_demotion`` and ``repro_torch.core.tpu_predictor``:
the selector's logic is the reference's (bound model, ``ALPHA``, the
feasibility rule, the tie-break toward more options) over the H100's
constants, and the planner sizes each site by what the port's kernels hold
(``flash_attention.choose_tile`` / ``plan_smem_bytes``,
``mamba2_ssd.choose_plan``).  The selector also ranks records of the port's
own dry-run.
"""

import pytest
import torch
import torch.distributed as dist

import repro_torch.configs as tconfigs
from repro_torch.configs import ShapeCell, get_config
from repro_torch.core.tpu_predictor import (
    ALPHA, HBM_BW, LINK_BW, PEAK_FLOPS, VariantCost, cost_from_record, select,
)
from repro_torch.core.vmem_demotion import (
    ON_CHIP_BUDGET, Residency, Site, attention_site, plan_residency, spilled_hbm_traffic,
    ssd_site,
)
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import mamba2_ssd as ssd

torch.set_num_threads(1)


def _cost(name, c, m, k, fits=True, opts=0):
    return VariantCost(name, c, m, k, fits_hbm=fits, n_options=opts)


def test_selector_prefers_lower_bound():
    best, ranked = select([
        _cost("a", 1.0, 0.1, 0.1),
        _cost("b", 0.5, 0.1, 0.1),
    ])
    assert best.name == "b"
    assert [v.name for v in ranked] == ["b", "a"]


def test_selector_never_ships_infeasible():
    """The paper's worst-case-avoidance contract: a variant that overflows HBM
    is never chosen when a feasible one exists."""
    best, ranked = select([
        _cost("fast_but_oom", 0.1, 0.1, 0.1, fits=False),
        _cost("fits", 0.5, 0.1, 0.1, fits=True),
    ])
    assert best.name == "fits"
    assert ranked[0].name == "fast_but_oom"      # ranked by estimate, shipped by feasibility


def test_selector_tie_breaks_toward_more_options():
    # paper §5.7: ties break toward the variant with more options enabled
    best, _ = select([
        _cost("plain", 1.0, 0.2, 0.2, opts=0),
        _cost("optimized", 1.0, 0.2, 0.2, opts=3),
    ])
    assert best.name == "optimized"


def test_overlap_model():
    v = _cost("x", 1.0, 0.5, 0.25)
    assert v.dominant == "compute"
    assert v.estimate_s == pytest.approx(1.0 + ALPHA * 0.75)
    assert ALPHA == 0.15


def test_cost_from_dryrun_record():
    """Each term is 0.01 s at the H100's published rates (989 TFLOP/s bf16,
    3.35 TB/s, NVLink 450 GB/s a direction), and the fit is against the
    card's memory, 80 GB by default."""
    assert (PEAK_FLOPS, HBM_BW, LINK_BW) == (989e12, 3.35e12, 450e9)
    rec = {
        "arch": "qwen2_7b",
        "shape": "train_4k",
        "flops": 9.89e12,          # exactly 0.01 s at peak
        "bytes_accessed": 3.35e10,  # exactly 0.01 s at HBM bw
        "collectives": {"total_bytes": 1, "wire_bytes": int(4.5e9)},
        "memory": {"argument_bytes": 2**30, "temp_bytes": 2**30, "output_bytes": 0},
    }
    v = cost_from_record(rec)
    assert v.compute_s == pytest.approx(0.01)
    assert v.memory_s == pytest.approx(0.01)
    assert v.collective_s == pytest.approx(0.01)
    assert v.fits_hbm and v.name == "qwen2_7b/train_4k/base"
    assert not cost_from_record(rec, hbm_bytes=2**31 - 1).fits_hbm


@pytest.fixture
def dryrun_records(monkeypatch):
    """Records of the port's dry-run: reduced stablelm, a training cell on the
    card's one-rank mesh, remat {none, full} x microbatches {1, 4}."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_dryrun_mesh

    monkeypatch.setattr(dryrun, "get_config", tconfigs.reduced_config)
    mesh = make_dryrun_mesh("1gpu")
    cell = ShapeCell("train_64x8", 64, 8, "train")
    try:
        yield {(remat, mb): dryrun.run_cell("stablelm_3b", cell, mesh, "1gpu", remat=remat,
                                            microbatches=mb)
               for remat in ("none", "full") for mb in (1, 4)}
    finally:
        dist.destroy_process_group()


def test_selector_on_real_dryrun_records(dryrun_records):
    """End-to-end on the port's own records: remat and microbatches lower the
    peak and add work.  With the memory set between the smallest and the
    largest footprint, the selector rejects every variant that overflows and
    ships the fastest that fits; with room for all it ships the fastest."""
    recs = dryrun_records
    assert all(r["status"] == "ok" for r in recs.values()), recs
    used = {k: sum(r["memory"][f] for f in ("argument_bytes", "temp_bytes", "output_bytes"))
            for k, r in recs.items()}
    assert used[("full", 4)] < used[("none", 1)]
    assert recs[("full", 1)]["flops"] > recs[("none", 1)]["flops"]
    budget = (used[("full", 4)] + used[("none", 1)]) // 2
    costs = {k: cost_from_record(r, name=f"remat_{k[0]}_mb{k[1]}", hbm_bytes=budget)
             for k, r in recs.items()}
    assert not costs[("none", 1)].fits_hbm and costs[("full", 4)].fits_hbm
    best, ranked = select(list(costs.values()))
    fitting = [v for v in costs.values() if v.fits_hbm]
    assert best.fits_hbm and best.estimate_s == min(v.estimate_s for v in fitting)
    assert len(ranked) == 4
    roomy = [cost_from_record(r, name=str(k)) for k, r in recs.items()]
    assert select(roomy)[0].estimate_s == min(v.estimate_s for v in roomy)


# ---------------------------------------------------------------------------
# On-chip residency planner
# ---------------------------------------------------------------------------


def test_attention_site_fits_and_demotes():
    """qwen2_7b's 4,096-token prefill: the mma block's accumulator registers
    and shared memory fit one block's budget, so m / l / acc stay on chip."""
    cfg = get_config("qwen2_7b")
    site = attention_site(cfg, seq_q=4096, seq_kv=4096)
    plan = fa.choose_tile(4096, 4096, cfg.dh, dtype=torch.bfloat16, groups=7)
    assert plan.path == "mma"
    assert site.state_bytes == fa.mma_accumulator_registers(cfg.dh, plan.bkv) * 4 * plan.threads
    assert 2 * site.operand_bytes == fa.plan_smem_bytes(plan, cfg.dh, 4096)
    assert site.steps == 4096 // plan.bkv
    plan_ = plan_residency([site])
    assert plan_[site.name] is Residency.RESIDENT_ON_CHIP
    assert spilled_hbm_traffic(site, plan_[site.name]) == 0


def test_oversized_site_spills_or_recomputes():
    huge = Site("huge", state_bytes=ON_CHIP_BUDGET * 2, operand_bytes=1024,
                spill_bytes_per_step=ON_CHIP_BUDGET, steps=8)
    plan = plan_residency([huge])
    assert plan["huge"] in (Residency.SPILL_HBM, Residency.RECOMPUTE)
    assert spilled_hbm_traffic(huge, plan["huge"]) > 0


def test_plan_prioritizes_expensive_spills():
    a = Site("cheap", state_bytes=ON_CHIP_BUDGET // 2 - 4096, operand_bytes=1024,
             spill_bytes_per_step=10, steps=2)
    b = Site("hot", state_bytes=ON_CHIP_BUDGET // 2 - 4096, operand_bytes=1024,
             spill_bytes_per_step=10_000_000, steps=64)
    plan = plan_residency([a, b], budget=ON_CHIP_BUDGET // 2)
    # only one fits: it must be the one whose spill would be most expensive
    assert plan["hot"] is Residency.RESIDENT_ON_CHIP
    assert plan["cheap"] is not Residency.RESIDENT_ON_CHIP


def test_ssd_site_matches_kernel_scratch():
    """The SSD kernel's block (``mamba2_ssd.choose_plan``: mamba2_370m's
    bf16 prefill) owns ``p_block`` rows of the ``(P, N)`` float32 state of
    one head and walks the sequence in 64-row chunks; its state and shared
    memory fit, so the plan keeps the state on chip."""
    cfg = get_config("mamba2_370m")
    site = ssd_site(cfg, seq=4096)
    plan = ssd.choose_plan(1, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, torch.bfloat16)
    assert site.state_bytes == plan.p_block * cfg.ssm_state * 4
    assert 2 * site.operand_bytes == plan.smem_bytes == ssd.smem_bytes(cfg.ssm_state,
                                                                       plan.p_block, "mma")
    assert site.steps == 4096 // ssd.CHUNK
    assert plan.blocks * site.state_bytes == cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state * 4
    assert plan_residency([site])[site.name] is Residency.RESIDENT_ON_CHIP


def test_block_size_chooser_responds_to_budget():
    """The demotion knob: less shared memory a block -> smaller tiles (the
    occupancy-cliff analogue), never one the kernel is not built for."""
    big = fa.choose_tile(8192, 8192, 128, smem_budget=fa.SMEM_PER_BLOCK)
    small = fa.choose_tile(8192, 8192, 128, smem_budget=64 * 1024)
    assert big.bq * big.bkv > small.bq * small.bkv
    assert fa.plan_smem_bytes(small, 128, 8192) <= 64 * 1024 < fa.plan_smem_bytes(big, 128, 8192)
    for plan in (big, small):
        assert plan.bq in fa.TILE_Q and plan.bkv in fa.TILE_KV
    mma = fa.choose_tile(8192, 8192, 128, dtype=torch.bfloat16)
    tight = fa.choose_tile(8192, 8192, 128, dtype=torch.bfloat16,
                           smem_budget=fa.mma_smem_bytes(128, 32, 8192))
    assert (mma.bkv, tight.bkv) == (64, 32)
