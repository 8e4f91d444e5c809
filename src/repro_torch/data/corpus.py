"""Real-workload kernel corpus: Profiles extracted from the model stack's kernels.

The port's own copy of the reference package's corpus.  The nine
:data:`~repro_torch.core.kernelgen.PAPER_BENCHMARKS` profiles mirror the
paper's hand-picked SHOC/Rodinia kernels.  This module derives a *second*
benchmark corpus nobody hand-picked: for every registered model config
(:mod:`repro_torch.configs`) and both serving phases (prefill + decode), the
reference package's two Pallas kernels (flash attention and the Mamba-2 SSD
scan) are instantiated at their real launch geometry and mapped onto a
register/shared-memory/instruction-mix
:class:`~repro_torch.core.kernelgen.Profile` the RegDem pipeline can tune.
The profiles are the reference's, field for field: the launch geometry is the
Pallas kernels' TPU tiling, not the tiling of this package's CUDA kernels
(whose compiled register and shared-memory counts ``chip_smoke.py`` prints
beside these).

Extraction model (deterministic, pure arithmetic — golden-pinned in
``tests/golden/corpus_profiles.json``):

* **block geometry** comes from the reference Pallas kernels' own TPU
  tilers (:func:`tpu_attention_blocks`, a copy of the reference attention
  kernel's block chooser; the SSD head-block formula), at the serving shapes
  of :data:`repro_torch.configs.base.SHAPES` (``prefill_32k`` /
  ``decode_32k``, clamped to per-model limits such as whisper's 1500-frame
  encoder);
* **threads/block** is one thread per q-row (attention) or per head-block
  lane group (SSD), clamped to the launchable [64, 256] range;
* **registers** count the per-thread live state the VMEM scratch holds on
  TPU: the accumulator slice + softmax running max/normalizer + operand
  fragment (attention), or the recurrent-state slice (SSD), plus the
  generator ABI (fixed + const-pool + temps);
* **shared memory** is the per-block share of the operand tiles a GPU
  lowering would stage (kv tile / B,C tile), capped inside the 48 KiB
  per-block limit so demotion still has spill room;
* **instruction mix** follows the kernel bodies: streaming operand loads,
  one store per chunk for SSD, SFU traffic for every ``exp``, predication
  where masking (window/chunk/causal-decode) predicates the inner loop;
* **regdem_target** is the first occupancy cliff
  (:func:`~repro_torch.core.occupancy.spill_targets`) below the extracted
  register count — exactly the paper's §3 target chooser.

The corpus deliberately exercises ranges the synthetic nine never hit:
single-row decode blocks (threads=64, 2-trip loops), 24 KiB static shared
memory next to 80+ registers, and wide-head accumulators.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from repro_torch.core.kernelgen import N_FIXED, Profile

#: serving shape cells (mirrors repro_torch.configs.base.SHAPES, serving subset)
PREFILL_SEQ, PREFILL_BATCH = 32_768, 32
DECODE_SEQ, DECODE_BATCH = 32_768, 128

#: whisper limits (encoder frames / decoder positions)
WHISPER_FRAMES, WHISPER_DECODE = 1500, 448


@dataclass(frozen=True)
class KernelInstance:
    """One real Pallas kernel launch: (model config, phase, kernel, shapes)."""

    model: str
    phase: str                     # prefill | decode
    kernel: str                    # attn | ssd
    batch: int
    # attention geometry
    seq_q: int = 0
    seq_kv: int = 0
    heads: int = 0
    dh: int = 0
    window: Optional[int] = None
    chunk: Optional[int] = None
    # ssd geometry
    ssd_heads: int = 0
    ssd_head_dim: int = 0
    ssd_state: int = 0
    ssd_chunk: int = 0
    seq: int = 0

    @property
    def name(self) -> str:
        return f"{self.model}.{self.phase}.{self.kernel}"


def _clamp(x: int, lo: int, hi: int) -> int:
    return max(lo, min(hi, x))


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _align(x: int, unit: int) -> int:
    return _ceil_div(x, unit) * unit


def _seed_of(name: str) -> int:
    # stable across runs/processes: content-derived, never hash()-derived
    return zlib.crc32(name.encode("utf-8")) % 10_000


# ---------------------------------------------------------------------------
# Launch-geometry enumeration
# ---------------------------------------------------------------------------


def kernel_instances() -> List[KernelInstance]:
    """Every (model config x phase) Pallas kernel launch, in registry order."""
    from repro_torch.configs.base import ARCH_IDS, get_config

    out: List[KernelInstance] = []
    for model in ARCH_IDS:
        cfg = get_config(model)
        attn = cfg.family in ("dense", "moe", "vlm", "audio", "hybrid")
        ssd = cfg.family in ("ssm", "hybrid")
        for phase in ("prefill", "decode"):
            if attn:
                if cfg.family == "audio":
                    # whisper: encoder self-attention at prefill, decoder
                    # cross-attention over the 1500 encoder frames at decode
                    sq = WHISPER_FRAMES if phase == "prefill" else 1
                    skv = WHISPER_FRAMES
                else:
                    sq = PREFILL_SEQ if phase == "prefill" else 1
                    skv = PREFILL_SEQ if phase == "prefill" else DECODE_SEQ
                out.append(
                    KernelInstance(
                        model=model,
                        phase=phase,
                        kernel="attn",
                        batch=PREFILL_BATCH if phase == "prefill" else DECODE_BATCH,
                        seq_q=sq,
                        seq_kv=skv,
                        heads=cfg.n_heads,
                        dh=cfg.dh,
                        window=cfg.window,
                        chunk=cfg.attn_chunk,
                    )
                )
            if ssd:
                out.append(
                    KernelInstance(
                        model=model,
                        phase=phase,
                        kernel="ssd",
                        batch=PREFILL_BATCH if phase == "prefill" else DECODE_BATCH,
                        ssd_heads=cfg.ssm_heads,
                        ssd_head_dim=cfg.ssm_head_dim,
                        ssd_state=cfg.ssm_state,
                        ssd_chunk=cfg.ssm_chunk,
                        seq=PREFILL_SEQ if phase == "prefill" else cfg.ssm_chunk,
                    )
                )
    return out


# ---------------------------------------------------------------------------
# Profile extraction
# ---------------------------------------------------------------------------


def _finish(name: str, target: int, threads: int, num_blocks: int,
            smem: int, **mix) -> Profile:
    """Common tail: pick the occupancy-cliff demotion target (§3) and the
    nvcc-spill stand-in, then assemble the Profile."""
    from repro_torch.core.occupancy import spill_targets

    # only cliffs strictly below the extracted count are real demotion
    # targets (spill_targets floors at 32, which can sit *above* a small
    # decode kernel's register count — flushed by the first corpus sweep)
    targets = [t for t in spill_targets(target, threads, smem) if t < target]
    regdem_target = targets[0] if targets else max(target - 6, 24)
    nvcc_spills = min(10, max(0, (target - regdem_target) // 3))
    return Profile(
        name=name,
        target_regs=target,
        threads_per_block=threads,
        num_blocks=num_blocks,
        shared_size=smem,
        regdem_target=regdem_target,
        nvcc_spills=nvcc_spills,
        seed=_seed_of(name),
        **mix,
    )


def extract_profile(inst: KernelInstance) -> Profile:
    """Map one real kernel launch onto a RegDem generation profile."""
    if inst.kernel == "attn":
        return _extract_attention(inst)
    return _extract_ssd(inst)


#: the reference Pallas attention kernel's TPU tiler, kept here as arithmetic
#: (the port's CUDA kernel tiles with ``kernels.flash_attention.choose_tile``
#: instead; the corpus models the reference kernel's launch geometry)
TPU_VMEM_BUDGET = 64 * 1024 * 1024   # per-core VMEM budget (bytes)
TPU_SUBLANE = 8                      # sublane alignment of a block's rows
TPU_BLOCK_LADDER = (2048, 1024, 512, 256, 128)


def tpu_attention_blocks(
    seq_q: int, seq_kv: int, head_dim: int, dtype_bytes: int = 2,
    vmem_budget: int = TPU_VMEM_BUDGET,
) -> Tuple[int, int]:
    """(bq, bkv) as the reference Pallas attention kernel picks them on a TPU:
    the largest ladder blocks whose double-buffered operands plus f32 scratch
    fit the VMEM budget, SUBLANE-aligned and never above the SUBLANE-rounded
    sequence length."""
    def fits(bq: int, bkv: int) -> bool:
        operand = (bq * head_dim + 2 * bkv * head_dim) * dtype_bytes
        scratch = (bq * bkv + 2 * bq * head_dim + 2 * bq) * 4
        return 2 * operand + scratch <= vmem_budget

    sq = _align(max(seq_q, 1), TPU_SUBLANE)
    skv = _align(max(seq_kv, 1), TPU_SUBLANE)
    cand_q = [c for c in TPU_BLOCK_LADDER if c <= sq] or [sq]
    cand_kv = [c for c in TPU_BLOCK_LADDER if c <= skv] or [skv]
    for bq in cand_q:
        for bkv in cand_kv:
            if fits(bq, bkv):
                return bq, bkv
    return cand_q[-1], cand_kv[-1]


def _extract_attention(inst: KernelInstance) -> Profile:
    bq, bkv = tpu_attention_blocks(inst.seq_q, inst.seq_kv, inst.dh)
    # one thread per q row of the block, floored at two warps
    threads = _clamp(bq, 64, 256)
    q_blocks = _ceil_div(inst.seq_q, bq)
    num_blocks = _clamp(inst.batch * inst.heads * q_blocks, 8, 65_535)
    trips = _clamp(_ceil_div(inst.seq_kv, bkv), 2, 24)
    # per-thread online-softmax state: the acc slice (f32 words of the
    # (bq, dh) accumulator owned by this thread), m/l, and a q fragment
    acc_words = _clamp((bq * inst.dh) // (threads * 4), 6, 56)
    qfrag = _clamp(inst.dh // 32, 2, 8)
    n_state = acc_words + qfrag + 2
    n_consts, n_temps = 8, 6
    target = N_FIXED + n_consts + n_temps + n_state
    # kv-tile stage: the per-block share of the k+v operand tiles (1/16th,
    # the per-warp slice), capped to leave spill room under the 48 KiB limit
    smem = min(24_576, _align(2 * bkv * inst.dh * 2 // 16, 256))
    masked = inst.window is not None or inst.chunk is not None
    return _finish(
        inst.name, target, threads, num_blocks, smem,
        loop_trips=trips,
        n_consts=n_consts,
        n_temps=n_temps,
        loads_per_iter=2 + (inst.dh > 64),    # k tile + v tile (+wide second beat)
        stores_per_iter=1 if inst.phase == "prefill" else 0,
        smem_ops_per_iter=2,                  # stage/consume the kv tile
        sfu_per_iter=1 + masked,              # exp (+ mask-boundary recompute)
        predicated=masked or inst.phase == "decode",
    )


def _extract_ssd(inst: KernelInstance) -> Profile:
    P, N, H = inst.ssd_head_dim, inst.ssd_state, inst.ssd_heads
    # the kernel's own head-block formula (ssd_pallas): largest head block
    # whose f32 state fits the 8 MiB scratch share, rounded to divide H
    hb = min(H, max(1, (8 * 1024 * 1024) // (P * N * 4)))
    while H % hb:
        hb -= 1
    threads = _clamp(_align(hb * 4, 32), 64, 256)
    n_chunks = _ceil_div(inst.seq, inst.ssd_chunk)
    num_blocks = _clamp(inst.batch * (H // hb), 8, 65_535)
    trips = _clamp(n_chunks, 2, 24)
    # per-thread slice of the (hb, P, N) recurrent state + decay scalars
    state_words = _clamp((hb * P * N) // (threads * 32), 10, 56)
    n_state = state_words + 4
    n_consts, n_temps = 8, 8
    target = N_FIXED + n_consts + n_temps + n_state
    # B/C tile stage: per-block share of the (chunk, N) operand tiles
    smem = min(16_384, _align(2 * inst.ssd_chunk * N * 4 // 8, 256))
    return _finish(
        inst.name, target, threads, num_blocks, smem,
        loop_trips=trips,
        n_consts=n_consts,
        n_temps=n_temps,
        loads_per_iter=3,                     # x, B, C tiles
        stores_per_iter=1,                    # y written back per chunk
        smem_ops_per_iter=2,                  # stage/consume the B/C tiles
        sfu_per_iter=2,                       # exp(segsum), exp(decay)
        predicated=False,
    )


# ---------------------------------------------------------------------------
# The corpus
# ---------------------------------------------------------------------------


def corpus_profiles() -> Dict[str, Profile]:
    """name -> Profile for every real kernel launch (the corpus)."""
    return {inst.name: extract_profile(inst) for inst in kernel_instances()}


#: the second benchmark corpus, alongside kernelgen.PAPER_BENCHMARKS
CORPUS_BENCHMARKS: Dict[str, Profile] = corpus_profiles()


def corpus_kernel(name: str):
    """Generate + schedule one corpus kernel (like ``paper_kernel``)."""
    from repro_torch.core.kernelgen import generate

    return generate(CORPUS_BENCHMARKS[name])


def all_corpus_kernels() -> Dict[str, object]:
    from repro_torch.core.kernelgen import generate

    return {name: generate(p) for name, p in CORPUS_BENCHMARKS.items()}


def model_corpus_names(model: str) -> List[str]:
    """The corpus kernels one model config's serving path launches."""
    names = [n for n in CORPUS_BENCHMARKS if n.split(".", 1)[0] == model]
    if not names:
        known = sorted({n.split(".", 1)[0] for n in CORPUS_BENCHMARKS})
        raise KeyError(f"no corpus kernels for model {model!r} (known: {known})")
    return names


def corpus_container(model: str, arch: str = "maxwell") -> bytes:
    """Multi-kernel container bytes for one model config's corpus kernels —
    the payload the tune-and-serve path feeds ``TranslationService.tune``."""
    from repro_torch.arch import retarget
    from repro_torch.binary import container
    from repro_torch.core.kernelgen import generate

    kernels = []
    for name in model_corpus_names(model):
        k = generate(CORPUS_BENCHMARKS[name])
        kernels.append(k if arch == "maxwell" else retarget(k, arch))
    return container.dumps(kernels)
