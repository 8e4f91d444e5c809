"""Two-stage simulator engine + SimCache + verify-policy tests.

The engine rewrite (trace compiler + event-driven issue loop) must be
*cycle-exact* with the pre-optimization engine:

* a golden file (``tests/golden/sim_cycles.json``, captured from the
  reference engine before the rewrite) pins ``total_cycles`` /
  ``cycles_per_wave`` / ``issue_stalls`` for every paper benchmark × all
  five variants;
* :func:`repro_torch.core.simulator.simulate_reference` (the old loop, kept
  verbatim) is compared live against the new engine on a sample of kernels,
  including an FP64-heavy one that exercises the capacity-crawl fast path.

The content-addressed :class:`~repro_torch.core.simcache.SimCache` must be
invisible: a hit returns a result equal to a fresh simulation, and a
colliding-but-different kernel is never served another kernel's result.
The pipeline's ``verify="final"`` hot-path policy must produce containers
byte-identical to ``verify="each"``.
"""

import dataclasses
import json
import os

import pytest

from repro_torch.binary import dumps
from repro_torch.core import _native
from repro_torch.core.kernelgen import PAPER_BENCHMARKS, Profile, generate, paper_kernel
from repro_torch.core.simcache import SimCache, simulate_cached
from repro_torch.core.simulator import (
    CheckpointStore,
    compile_trace,
    flatten_trace,
    simulate,
    simulate_batch,
    simulate_reference,
)
from repro_torch.core.variants import make_variants

GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "golden", "sim_cycles.json")


@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN_PATH) as fh:
        return json.load(fh)


@pytest.fixture(scope="module")
def all_variants():
    return {name: make_variants(PAPER_BENCHMARKS[name]) for name in PAPER_BENCHMARKS}


# ---------------------------------------------------------------------------
# golden cycle parity (all paper benchmarks x all five variants)
# ---------------------------------------------------------------------------


def test_golden_covers_full_matrix(golden):
    want = {f"{n}/{v}" for n in PAPER_BENCHMARKS for v in
            ("nvcc", "regdem", "local", "local-shared", "local-shared-relax")}
    assert set(golden) == want


def test_engine_matches_golden_cycles(golden, all_variants):
    """The new engine reproduces the pre-rewrite engine's cycles exactly."""
    for name, vs in all_variants.items():
        for vn, v in vs.items():
            s = simulate(v.kernel)
            g = golden[f"{name}/{vn}"]
            got = {
                "total_cycles": s.total_cycles,
                "cycles_per_wave": s.cycles_per_wave,
                "dynamic_instructions": s.dynamic_instructions,
                "issue_stalls": s.issue_stalls,
            }
            assert got == g, f"{name}/{vn}"


# ---------------------------------------------------------------------------
# live old-engine vs new-engine parity (a sample incl. the FP64 crawl path)
# ---------------------------------------------------------------------------

#: small FP64-bound profile: short trace, but saturates the 4-lane FP64 unit,
#: driving the issue loop through its capacity-crawl skip
_MINI_FP64 = Profile(
    name="mini_fp64", target_regs=48, threads_per_block=128, num_blocks=512,
    shared_size=0, regdem_target=40, nvcc_spills=0, loop_trips=3,
    n_consts=4, n_temps=4, fp64_frac=1.0, loads_per_iter=1, seed=7,
)


def _parity_kernels(all_variants):
    yield "mini_fp64", generate(_MINI_FP64)
    yield "gaussian/nvcc", all_variants["gaussian"]["nvcc"].kernel
    yield "gaussian/regdem", all_variants["gaussian"]["regdem"].kernel
    yield "nn/local-shared", all_variants["nn"]["local-shared"].kernel


def test_engine_matches_reference_engine(all_variants):
    for label, k in _parity_kernels(all_variants):
        new = simulate(k)
        old = simulate_reference(k)
        assert dataclasses.asdict(new) == dataclasses.asdict(old), label


def test_engine_matches_reference_under_truncation():
    """Parity must hold in the max_cycles-truncation regime too — the
    capacity-crawl bulk jump has to stop exactly where the reference's
    cycle-by-cycle crawl stops."""
    k = generate(_MINI_FP64)
    full = simulate(k).cycles_per_wave
    for cap in (1, 7, full // 3, full // 2, full - 1, full + 10):
        new = simulate(k, max_cycles=cap)
        old = simulate_reference(k, max_cycles=cap)
        assert dataclasses.asdict(new) == dataclasses.asdict(old), f"max_cycles={cap}"


def test_compile_trace_lowers_unique_instructions_once():
    k = paper_kernel("conv")
    trace = flatten_trace(k)
    ct = compile_trace(trace)
    assert len(ct.code) == len(trace)
    uniq = {ins.uid for ins in trace}
    assert len(ct.klass) == len(uniq)  # one record per static instruction
    assert all(0 <= j < len(ct.klass) for j in ct.code)


# ---------------------------------------------------------------------------
# SimCache properties
# ---------------------------------------------------------------------------


def test_simcache_hit_equals_fresh_simulation(all_variants):
    cache = SimCache()
    for vn, v in all_variants["cfd"].items():
        fresh = simulate(v.kernel)
        miss = cache.simulate(v.kernel)
        hit = cache.simulate(v.kernel)
        assert dataclasses.asdict(miss) == dataclasses.asdict(fresh), vn
        assert dataclasses.asdict(hit) == dataclasses.asdict(fresh), vn
    assert cache.hits == len(all_variants["cfd"])
    assert cache.misses == len(all_variants["cfd"])


def test_simcache_hit_returns_a_copy(all_variants):
    cache = SimCache()
    k = all_variants["cfd"]["nvcc"].kernel
    first = cache.simulate(k)
    first.total_cycles = -1  # caller mutates its copy...
    again = cache.simulate(k)
    assert again.total_cycles != -1  # ...without poisoning the cache


def test_simcache_keys_on_content_not_identity(all_variants):
    """A copy of a kernel (new uids, same content) is a hit; a kernel whose
    content differs (here: launch geometry) is not served the stale entry."""
    cache = SimCache()
    k = all_variants["cfd"]["nvcc"].kernel
    r1 = cache.simulate(k)
    r2 = cache.simulate(k.copy())
    assert cache.hits == 1
    assert dataclasses.asdict(r1) == dataclasses.asdict(r2)

    bigger = k.copy()
    bigger.num_blocks *= 2
    r3 = cache.simulate(bigger)
    assert r3.total_cycles > r1.total_cycles  # fresh sim, not the cached one


def test_simulate_cached_uses_supplied_cache(all_variants):
    cache = SimCache()
    k = all_variants["nn"]["nvcc"].kernel
    simulate_cached(k, cache=cache)
    simulate_cached(k, cache=cache)
    assert cache.hits == 1 and cache.misses == 1


def test_simcache_bounded_eviction(all_variants):
    cache = SimCache(max_entries=1)
    a = all_variants["cfd"]["nvcc"].kernel
    b = all_variants["nn"]["nvcc"].kernel
    cache.simulate(a)
    cache.simulate(b)   # evicts a (FIFO bound of 1)
    cache.simulate(a)   # miss again
    assert cache.hits == 0 and cache.misses == 3


# ---------------------------------------------------------------------------
# native engine vs Python fallback conformance
# ---------------------------------------------------------------------------

needs_native = pytest.mark.skipif(
    not _native.available(), reason="compiled engine unavailable (no C compiler)"
)


@needs_native
def test_native_engine_matches_python_engine(all_variants, monkeypatch):
    """The compiled issue loop is state-for-state identical to the Python
    fallback — results AND stall-attribution books, over the parity sample
    (which includes the FP64 capacity-crawl path)."""
    sample = list(_parity_kernels(all_variants))
    native = [simulate(k, profile=True) for _, k in sample]
    monkeypatch.setenv("REGDEM_SIM_NATIVE", "0")
    fallback = [simulate(k, profile=True) for _, k in sample]
    for (label, _), a, b in zip(sample, native, fallback):
        assert dataclasses.asdict(a) == dataclasses.asdict(b), label


@needs_native
def test_native_and_python_capture_identical_checkpoints(all_variants, monkeypatch):
    """Both engines capture checkpoints at the same trace milestones with
    bit-identical state (clocks are IEEE-754 doubles in both)."""
    k = all_variants["gaussian"]["regdem"].kernel
    s_native = CheckpointStore()
    simulate(k, profile=True, checkpoints=s_native)
    monkeypatch.setenv("REGDEM_SIM_NATIVE", "0")
    s_py = CheckpointStore()
    simulate(k, profile=True, checkpoints=s_py)
    assert len(s_native) >= 1
    assert s_native._entries.keys() == s_py._entries.keys()
    for key, cp in s_native._entries.items():
        assert cp == s_py._entries[key], key[1]


# ---------------------------------------------------------------------------
# incremental re-simulation: checkpoint capture + resume exactness
# ---------------------------------------------------------------------------


@pytest.fixture(params=["native", "python"])
def engine_mode(request, monkeypatch):
    """Run checkpoint semantics under both engines."""
    if request.param == "native":
        if not _native.available():
            pytest.skip("compiled engine unavailable")
    else:
        monkeypatch.setenv("REGDEM_SIM_NATIVE", "0")
    return request.param


def test_checkpoint_resume_matches_cold_run(all_variants, engine_mode):
    k = all_variants["gaussian"]["regdem"].kernel
    cold = simulate(k)
    store = CheckpointStore()
    first = simulate(k, checkpoints=store)   # cold, captures milestones
    assert len(store) >= 1
    resumed = simulate(k, checkpoints=store)  # resumes from the deepest
    assert store.hits >= 1
    assert dataclasses.asdict(first) == dataclasses.asdict(cold)
    assert dataclasses.asdict(resumed) == dataclasses.asdict(cold)
    assert 0.0 < store.reuse_rate <= 1.0
    st = store.stats()
    assert st["entries"] == len(store) and st["hits"] == store.hits


def test_checkpoint_resume_profiled_books_exact(all_variants, engine_mode):
    """A resumed profiled run restores the mid-trace blame books and ends
    with the exact stall attribution of a cold profiled run."""
    k = all_variants["nn"]["local-shared"].kernel
    cold = simulate(k, profile=True)
    store = CheckpointStore()
    simulate(k, profile=True, checkpoints=store)
    resumed = simulate(k, profile=True, checkpoints=store)
    assert store.hits >= 1
    assert resumed.stall_profile.to_json() == cold.stall_profile.to_json()
    assert resumed.total_cycles == cold.total_cycles


def test_plain_checkpoint_never_serves_profiled_run(all_variants, engine_mode):
    """A checkpoint without blame books cannot resume a profiled run (the
    books would start mid-trace with holes)."""
    k = all_variants["gaussian"]["nvcc"].kernel
    store = CheckpointStore()
    simulate(k, checkpoints=store)           # plain captures
    cold = simulate(k, profile=True)
    prof = simulate(k, profile=True, checkpoints=store)  # must not resume
    assert prof.stall_profile.to_json() == cold.stall_profile.to_json()


# ---------------------------------------------------------------------------
# batched entry point (the non-property smoke; the hypothesis differential
# lives in test_sim_batch_property.py)
# ---------------------------------------------------------------------------


def test_simulate_batch_matches_per_variant(all_variants):
    kernels = [v.kernel for v in all_variants["gaussian"].values()]
    solo = [simulate(k, profile=True) for k in kernels]
    batched = simulate_batch(kernels, profile=True)
    for vn, a, b in zip(all_variants["gaussian"], solo, batched):
        assert dataclasses.asdict(a) == dataclasses.asdict(b), vn


def test_simulate_batch_through_simcache_dedups(all_variants):
    k = all_variants["cfd"]["nvcc"].kernel
    cache = SimCache()
    res = cache.simulate_batch([k, k.copy(), k])
    assert cache.hits >= 2  # content-duplicates served from the cache
    assert len({r.total_cycles for r in res}) == 1
    stats = cache.stats()
    assert "checkpoint_entries" in stats and "checkpoint_reuse_rate" in stats


# ---------------------------------------------------------------------------
# trace-truncation cap is visible, never silent
# ---------------------------------------------------------------------------


def test_flatten_trace_truncation_is_visible():
    k = paper_kernel("cfd")
    k.name = "trunc_probe"
    full = flatten_trace(k)
    assert not full.truncated
    cap = len(full) // 2
    with pytest.warns(RuntimeWarning, match="truncated prefix"):
        t = flatten_trace(k, max_len=cap)
    assert t.truncated and len(t) == cap
    # the warning fires once per kernel; the truncated flag every time
    import warnings as _warnings

    with _warnings.catch_warnings():
        _warnings.simplefilter("error")
        t2 = flatten_trace(k, max_len=cap)
    assert t2.truncated


# ---------------------------------------------------------------------------
# verify="final" regression: byte-identical containers vs verify="each"
# ---------------------------------------------------------------------------


def test_verify_final_containers_byte_identical():
    for name in ("cfd", "md", "conv"):
        prof = PAPER_BENCHMARKS[name]
        each = make_variants(prof, verify="each")
        final = make_variants(prof, verify="final")
        blob_each = dumps([v.kernel for v in each.values()])
        blob_final = dumps([v.kernel for v in final.values()])
        assert blob_each == blob_final, name
