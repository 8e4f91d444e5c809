"""End-to-end demo on the port: tune a model config's kernel corpus, then serve it.

Stage 1 — **tune** (host code, no device): the model's kernels, extracted as
RegDem profiles by :mod:`repro_torch.data.corpus`, are packed into one
container and pushed through
:meth:`repro_torch.core.translator.TranslationService.tune` — the full
predictor-guided search — backed by a persistent
:class:`~repro_torch.core.artifacts.ArtifactStore`.  Run the script twice
with the same ``--store`` directory and the second tune is served **warm**:
every kernel is a disk cache hit, zero pipeline passes run, and the emitted
container bytes are identical.

Stage 2 — **serve**: the (reduced, unless ``--full``) model serves a batch of
requests with continuous batching through the port's ``Server``, on the GPU
by default (attention and the SSD scan through the CUDA kernels).

    PYTHONPATH=src python examples/torch_serve_batched.py
    PYTHONPATH=src python examples/torch_serve_batched.py --device cpu
    PYTHONPATH=src python examples/torch_serve_batched.py --store /tmp/regdem_cache
    PYTHONPATH=src python examples/torch_serve_batched.py --model zamba2_2_7b
"""

import argparse
import tempfile
import time

import numpy as np

from repro_torch import resolve_device
from repro_torch.configs import get_config, reduced_config
from repro_torch.core.artifacts import ArtifactStore
from repro_torch.core.passes import PIPELINE_COUNTERS
from repro_torch.core.search import SearchConfig
from repro_torch.core.translator import TranslationService
from repro_torch.data.corpus import corpus_container, model_corpus_names
from repro_torch.models import Model
from repro_torch.runtime import ServeConfig, Server
from repro_torch.runtime.serving import Request

#: small-but-real search: one cliff target per arch, top beam survivors only
TUNE = SearchConfig(max_targets=1, beam_width=2, top_k=1)


def tune_corpus(model: str, store_dir: str) -> None:
    """Tune the model's extracted kernel corpus against the artifact store."""
    names = model_corpus_names(model)
    data = corpus_container(model)
    svc = TranslationService(store=ArtifactStore(store_dir))
    t0 = time.time()
    _, report = svc.tune(data, TUNE)
    dt = time.time() - t0
    warm = report.cache_hits == len(names)
    print(
        f"tuned {len(names)} corpus kernels for {model} in {dt:.1f}s "
        f"({'WARM: all ' + str(report.cache_hits) + ' from store, zero passes' if warm else f'{report.cache_misses} searched, {report.cache_hits} cached'})"
    )
    for r in report.reports:
        sr = r.search
        line = f"  {r.kernel_name}: {r.baseline_regs} regs -> chose {r.chosen}"
        if sr is not None:
            line += f" ({sr.speedup:.3f}x vs nvcc, {sr.explored} variants explored)"
        print(line)

    # second tune of identical content: served entirely from the warm
    # TranslationCache/ArtifactStore — the serving-path invariant
    passes = PIPELINE_COUNTERS["passes"]
    again, rep2 = svc.tune(data, TUNE)
    assert rep2.cache_hits == len(names) and rep2.cache_misses == 0
    assert PIPELINE_COUNTERS["passes"] == passes, "a warm re-tune must run no pass"
    first, _ = TranslationService(store=ArtifactStore(store_dir)).tune(data, TUNE)
    assert first == again, "warm restart must be byte-identical"
    print(f"  re-tune: {rep2.cache_hits}/{len(names)} warm hits, byte-identical")


def serve(model: str, device: str, full: bool) -> None:
    dev = resolve_device(device)
    cfg = get_config(model) if full else reduced_config(model)
    state = Model(cfg, device=dev).init(seed=0).state_dict()
    server = Server(
        cfg,
        ServeConfig(batch_slots=4, max_len=64, max_new_tokens=12, eos=-1, temperature=0.0),
        state,
        device=dev,
    )
    del state
    rng = np.random.default_rng(0)
    requests = [
        Request(uid=i, prompt=rng.integers(1, cfg.vocab, size=rng.integers(4, 12)).astype(np.int32))
        for i in range(10)
    ]
    t0 = time.time()
    done = server.serve(requests)
    dt = time.time() - t0
    total_tokens = sum(len(c.tokens) for c in done)
    assert len(done) == len(requests) and all(len(c.tokens) == 12 for c in done)
    print(f"served {len(done)} requests / {total_tokens} tokens on {dev} in {dt:.1f}s "
          f"({total_tokens/dt:.1f} tok/s, 4 slots)")
    for c in done[:4]:
        print(f"  req {c.uid}: {len(c.tokens)} tokens, {c.latency_s*1e3:.0f} ms -> {c.tokens[:6]}...")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="gemma3_1b",
                    help="model config id (default gemma3_1b)")
    ap.add_argument("--store", default=None, metavar="DIR",
                    help="ArtifactStore directory; reuse it across runs for a "
                         "warm start (default: a fresh temp dir)")
    ap.add_argument("--device", default="cuda",
                    help="device that serves (default cuda; raises without one)")
    ap.add_argument("--full", action="store_true",
                    help="serve the model at full width instead of the reduced config")
    args = ap.parse_args()
    # refuse a missing device before the tune, not after it
    resolve_device(args.device)
    store_dir = args.store or tempfile.mkdtemp(prefix="regdem_store_")
    print(f"artifact store: {store_dir}")
    tune_corpus(args.model, store_dir)
    serve(args.model, args.device, args.full)
    print("OK")


if __name__ == "__main__":
    main()
