"""Deterministic synthetic LM data pipeline.

A copy of ``repro.data.pipeline`` (numpy only), kept here so that the port
imports nothing of the reference package: the same ``(seed, index)`` gives
the same batch, bit for bit, in both.

Properties a real-cluster pipeline needs, kept here at full fidelity:

* **determinism under restart**: batch ``i`` is a pure function of
  ``(seed, i)`` — resuming from a checkpoint at step ``k`` replays exactly
  the data the crashed run would have seen (tested bit-exact);
* **per-host sharding**: each host generates only its slice of the global
  batch (``host_id``/``n_hosts``), so no broadcast is needed at scale;
* **sequence packing**: documents of random length are packed into fixed
  ``seq_len`` rows with EOS separators, and loss masking marks the padding
  tail (``targets = -1``).

The token *contents* are a structured pseudo-corpus (a Zipfian unigram mix
with short-range repetition), not uniform noise, so small-model training
loss decreases measurably — the end-to-end example trains on it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    mean_doc_len: int = 192
    eos: int = 0


def _zipf_probs(vocab: int, alpha: float = 1.1) -> np.ndarray:
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = ranks ** (-alpha)
    return (p / p.sum()).astype(np.float64)


class SyntheticLM:
    """Iterator of global batches (optionally host-sliced)."""

    def __init__(self, cfg: DataConfig, host_id: int = 0, n_hosts: int = 1):
        if cfg.global_batch % n_hosts:
            raise ValueError("global_batch must divide across hosts")
        self.cfg = cfg
        self.host_id = host_id
        self.n_hosts = n_hosts
        self._probs = _zipf_probs(min(cfg.vocab, 8192))

    def batch(self, index: int) -> Dict[str, np.ndarray]:
        """The ``index``-th global batch (this host's slice)."""
        cfg = self.cfg
        per_host = cfg.global_batch // self.n_hosts
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, index, self.host_id])
        )
        rows = []
        for _ in range(per_host):
            rows.append(self._pack_row(rng))
        tokens = np.stack(rows)  # (per_host, seq_len+1)
        return {
            "tokens": tokens[:, :-1].astype(np.int32),
            "targets": tokens[:, 1:].astype(np.int32),
        }

    def _pack_row(self, rng: np.random.Generator) -> np.ndarray:
        cfg = self.cfg
        out = np.empty(cfg.seq_len + 1, dtype=np.int64)
        pos = 0
        while pos < cfg.seq_len + 1:
            remaining = cfg.seq_len + 1 - pos
            doc_len = int(rng.geometric(1.0 / cfg.mean_doc_len))
            doc_len = min(max(doc_len, 4), remaining)
            base = rng.choice(len(self._probs), size=doc_len, p=self._probs)
            # short-range repetition: makes next-token prediction learnable
            rep = rng.random(doc_len) < 0.35
            for i in range(1, doc_len):
                if rep[i]:
                    base[i] = base[i - 1]
            base = base % cfg.vocab
            base[0] = cfg.eos
            out[pos : pos + doc_len] = base
            pos += doc_len
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        i = 0
        while True:
            yield self.batch(i)
            i += 1


def make_batch_shapes(
    family: str,
    global_batch: int,
    seq_len: int,
    d_model: int = 0,
    n_patches: int = 0,
    n_frames: int = 0,
) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """(shape, dtype) stand-ins per input for ``input_specs()`` (dry-run)."""
    shapes: Dict[str, Tuple[Tuple[int, ...], str]] = {
        "tokens": ((global_batch, seq_len), "int32"),
        "targets": ((global_batch, seq_len), "int32"),
    }
    if family == "vlm":
        shapes["patch_embeds"] = ((global_batch, n_patches, d_model), "bfloat16")
        shapes["mrope_positions"] = ((global_batch, seq_len, 3), "int32")
    if family == "audio":
        shapes["frame_embeds"] = ((global_batch, n_frames, d_model), "bfloat16")
    return shapes
