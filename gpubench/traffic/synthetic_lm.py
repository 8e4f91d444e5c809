"""A frozen copy of the program's ``data/pipeline.py`` ``SyntheticLM`` (numpy
only): packed documents of geometric length, tokens from a Zipf unigram mix
with short-range repetition, each row starting a document with EOS.  Batch
``i`` is a pure function of ``(seed, i)``.  Kept here so that the training
cell's data cannot change under a later change to the program."""

from __future__ import annotations

from typing import Dict

import numpy as np


def zipf_probs(vocab: int, alpha: float = 1.1) -> np.ndarray:
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = ranks ** (-alpha)
    return (p / p.sum()).astype(np.float64)


class SyntheticLM:
    def __init__(self, vocab: int, seq_len: int, rows: int, seed: int, mean_doc_len: int = 192,
                 eos: int = 0):
        self.vocab, self.seq_len, self.rows, self.seed = vocab, seq_len, rows, seed
        self.mean_doc_len, self.eos = mean_doc_len, eos
        self._probs = zipf_probs(min(vocab, 8192))

    def batch(self, index: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, index, 0]))
        tokens = np.stack([self._pack_row(rng) for _ in range(self.rows)])
        return {"tokens": tokens[:, :-1].astype(np.int32),
                "targets": tokens[:, 1:].astype(np.int32)}

    def _pack_row(self, rng: np.random.Generator) -> np.ndarray:
        n = self.seq_len + 1
        out = np.empty(n, dtype=np.int64)
        pos = 0
        while pos < n:
            doc_len = min(max(int(rng.geometric(1.0 / self.mean_doc_len)), 4), n - pos)
            base = rng.choice(len(self._probs), size=doc_len, p=self._probs)
            rep = rng.random(doc_len) < 0.35
            for i in range(1, doc_len):
                if rep[i]:
                    base[i] = base[i - 1]
            base = base % self.vocab
            base[0] = self.eos
            out[pos:pos + doc_len] = base
            pos += doc_len
        return out
