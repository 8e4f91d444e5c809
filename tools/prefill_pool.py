#!/usr/bin/env python3
"""Memory of a Server's prefill graphs, by the order their lengths arrive.

    python3 tools/prefill_pool.py --arch llama4_scout_17b_a16e --layers 4
    python3 tools/prefill_pool.py --arch qwen2_moe_a2_7b --arch stablelm_3b

For each model (bf16, random weights from seed 0, ``--layers`` cuts the
depth), the prompt lengths of ``chip_smoke.py``'s serving phases (16 draws
from 64-512, numpy seed 0) are prefilled through a fresh ``Server`` in three
orders: as served, longest first and shortest first.  Each first sight of a
length captures its graph into the Server's shared pool: printed are each
capture's growth of the pool (MiB) and the pool after all of them.  Beside
them, the eager prefill's peak temporaries at every length (the growth of
``max_memory_allocated`` over one ``Model.prefill`` of the Server's model and
its logits), and the
memory an eager Server's allocator cache holds after serving the same
prompts (reserved less allocated).  Prints one JSON line a model, and the
card's name and power limit.  Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.runtime import Request, ServeConfig, Server  # noqa: E402

MIB = 2**20
SERVE = ServeConfig(batch_slots=8, max_len=1024, max_new_tokens=2, eos=-1)


def prompts(cfg):
    """The serving phases' 16 prompts (chip_smoke.serve_path's draws)."""
    rng = np.random.default_rng(0)
    lengths = rng.integers(64, 513, size=16)
    return [rng.integers(0, cfg.vocab, size=int(n)).astype(np.int32) for n in lengths]


def eager_temporaries(model, prompt):
    tokens = torch.from_numpy(prompt[None]).cuda()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    h, _ = model.prefill({"tokens": tokens}, SERVE.max_len)
    model.logits(h[:, -1:])
    torch.cuda.synchronize()
    return round((torch.cuda.max_memory_allocated() - base) / MIB, 1)


def captures(cfg, weights, order):
    """Pool growth of each capture, lengths taken in ``order``."""
    server = Server(cfg, SERVE, weights, device="cuda")
    growth = {}
    for prompt in order:
        n = len(prompt)
        if n in server.prefill_graphs:
            continue
        server._prefill(torch.from_numpy(prompt[None]).cuda())
        growth[n] = round(server.prefill_graphs[n].pool_bytes / MIB, 1)
    pool = round(sum(growth.values()), 1)
    del server
    gc.collect()
    torch.cuda.empty_cache()
    return {"pool_mib": pool, "growth_mib": growth}


def eager_cache(cfg, weights, served):
    """Reserved less allocated after an eager Server serves the prompts,
    over the same before it (the allocator's cache that serving left)."""
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved() - torch.cuda.memory_allocated()
    server = Server(cfg, SERVE, weights, device="cuda", cuda_graph=False)
    server.serve([Request(uid=i, prompt=p) for i, p in enumerate(served)])
    torch.cuda.synchronize()
    after = torch.cuda.memory_reserved() - torch.cuda.memory_allocated()
    del server
    gc.collect()
    torch.cuda.empty_cache()
    return round((after - before) / MIB, 1)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", action="append", required=True)
    ap.add_argument("--layers", type=int, default=None, help="cut every model to this depth")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("prefill_pool: no CUDA device", file=sys.stderr)
        return 1
    for arch in args.arch:
        cfg = get_config(arch)
        if args.layers:
            cfg = dataclasses.replace(cfg, n_layers=args.layers)
        model = Model(cfg, device="cuda").init(seed=0)
        weights = model.state_dict()
        served = prompts(cfg)
        # the Server's model (the kernels' paths), on the same weights
        eager = Server(cfg, SERVE, weights, device="cuda", cuda_graph=False).model
        temps = {len(p): eager_temporaries(eager, p) for p in sorted(served, key=len)}
        del eager
        longest = max(temps)
        rec = {"model": cfg.name, "layers": cfg.n_layers,
               "eager_peak_temporaries_mib": temps,
               "at_longest": temps[longest], "largest": max(temps.values()),
               "largest_at": max(temps, key=temps.get),
               "eager_cache_mib": eager_cache(cfg, weights, served)}
        for name, order in (("served", served), ("longest_first", sorted(served, key=len)[::-1]),
                            ("shortest_first", sorted(served, key=len))):
            rec[name] = captures(cfg, weights, order)
        print(json.dumps(rec), flush=True)
        del model, weights
        gc.collect()
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
