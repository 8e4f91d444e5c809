#!/usr/bin/env python3
"""Time the attention kernel of one source tree, eagerly and by CUDA graphs.

    python3 tools/attention_ab.py                     # this tree
    python3 tools/attention_ab.py --tree DIR          # the tree unpacked in DIR

The port's attention wrapper is imported from ``DIR/src`` and its kernel built
there (``DIR/build/repro_torch``), so one card can compare two commits: unpack
the other commit (``git archive``) into a directory that ``.gitignore`` lists and
run, in one job, other, this, this, other.  The inputs are those of
``chip_smoke.py``'s ``kernels`` phase (bf16, stablelm_3b's heads, numpy seed 0).
Each shape is timed two ways: ``ms``, CUDA events around 20 eager calls (the
host's time to issue each call included); ``device_ms``, one call's device
time from a CUDA graph of 20 calls.  Each is the least of two runs.  Prints
one JSON line, and the card's name and power limit.  Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

SHAPES = {
    # name: (B, Sq, Skv, Hq, Hkv, Dh), query positions
    "decode": ((8, 1, 1024, 32, 32, 80), "the last of a full cache"),
    "prefill": ((1, 512, 1024, 32, 32, 80), "the last 512 of a full cache"),
    "serve_decode": ((8, 1, 1024, 32, 32, 80), "slot lengths 64-544 from seed 1"),
    "serve_prefill": ((1, 512, 1024, 32, 32, 80), "a prompt from position 0"),
}


def make_case(name, B, Sq, Skv, Hq, Hkv, Dh, dev):
    rng = np.random.default_rng(0)

    def t(shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev).bfloat16()

    q, k, v = t((B, Sq, Hq, Dh)), t((B, Skv, Hkv, Dh)), t((B, Skv, Hkv, Dh))
    if name == "decode":
        qpos = torch.full((B, 1), Skv - 1, dtype=torch.int32, device=dev)
    elif name == "serve_decode":
        lengths = np.random.default_rng(1).integers(64, 545, size=B)
        qpos = torch.as_tensor(lengths[:, None] - 1, dtype=torch.int32, device=dev)
    elif name == "serve_prefill":
        qpos = torch.arange(Sq, dtype=torch.int32, device=dev)[None].expand(B, Sq)
    else:
        qpos = torch.arange(Skv - Sq, Skv, dtype=torch.int32, device=dev)[None].expand(B, Sq)
    kpos = torch.arange(Skv, dtype=torch.int32, device=dev)[None].expand(B, Skv)
    return q, k, v, qpos, kpos


def eager_ms(fn, warmup=3, iters=20):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def device_ms(fn, iters=20, replays=3):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    side.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (iters * replays)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    help="root of the source tree whose src/repro_torch is timed")
    ap.add_argument("--tag", default=None, help="a name for the tree in the output")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("attention_ab: no CUDA device", file=sys.stderr)
        return 1
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, os.path.join(tree, "src"))
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    out = {"tree": args.tag or tree, "shapes": {}}
    for name, (shape, positions) in SHAPES.items():
        q, k, v, qpos, kpos = make_case(name, *shape, dev)

        def run():
            return ops.flash_attention(q, k, v, qpos, kpos)

        got = run().float()
        mask = ref.attention_mask(qpos[:, None, :, None], kpos[:, None, None, :])
        want = torch.nn.functional.scaled_dot_product_attention(
            *(t.transpose(1, 2).float() for t in (q, k, v)), attn_mask=mask).transpose(1, 2)
        err = float((got - want).abs().max())
        if not err <= 2e-2 * (1 + float(want.abs().max())):
            print(f"attention_ab: the kernel disagrees with SDPA at {name} ({err})",
                  file=sys.stderr)
            return 1
        t_eager = [eager_ms(run) for _ in range(2)]
        t_dev = [device_ms(run) for _ in range(2)]
        out["shapes"][name] = {
            "shape": dict(zip(("B", "Sq", "Skv", "Hq", "Hkv", "Dh"), shape)),
            "query_positions": positions, "max_abs_err_vs_sdpa_fp32": err,
            "ms": min(t_eager), "ms_runs": t_eager,
            "device_ms": min(t_dev), "device_ms_runs": t_dev}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], stdout=subprocess.PIPE, text=True,
                          check=True).stdout.strip().splitlines()[0]
    out["card"] = card
    print(json.dumps(out), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
