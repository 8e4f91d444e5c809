#!/usr/bin/env python3
"""Time the SSD kernel of one source tree, eagerly and by CUDA graphs.

    python3 tools/ssd_ab.py                     # this tree
    python3 tools/ssd_ab.py --tree DIR          # the tree unpacked in DIR

The port's SSD wrapper is imported from ``DIR/src`` and its kernel built there
(``DIR/build/repro_torch``), so one card can compare two commits: unpack the
other commit (``git archive``) into a directory that ``.gitignore`` lists and
run, in one job, other, this, this, other.  The inputs are those of
``chip_smoke.py``'s ``kernels`` phase: one 512-token prompt of each model's
mamba layer in the model's layout (bf16 x, B and C cut from one tensor, fp32
dt, y asked for in fp32; numpy seed 0).  At each shape the wrapper's default
plan and every ``p_block`` are timed two ways: ``ms``, CUDA events around 20
eager calls (the host's time to issue each call included); ``device_ms``, one
call's device time from a CUDA graph of 20 calls.  Each is the least of two
runs.  Prints one JSON line, and the card's name and power limit.  Needs one
CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

from attention_ab import device_ms, eager_ms  # the same two clocks, beside this file

#: (H, P, N) of each model's mamba heads; one prompt of 512 tokens
SHAPES = {"mamba2_370m": (32, 64, 128), "zamba2_2_7b": (80, 64, 64)}
SEQ = 512
P_BLOCKS = (16, 32, 64)


def make_case(H, P, N, dev):
    """``chip_smoke.make_ssd(1, 512, H, P, N, bf16, model_layout=True, decays="model")``."""
    rng = np.random.default_rng(0)

    def t(shape, scale):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * scale).to(dev)

    xbc = t((1, SEQ, H * P + 2 * N), 0.5).bfloat16()
    x = xbc[..., :H * P].reshape(1, SEQ, H, P)
    bm, cm = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
    dt = torch.nn.functional.softplus(t((1, SEQ, H), 1.0))
    a = -torch.linspace(1.0, 16.0, H, device=dev)
    return x, dt, a, bm, cm


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    help="root of the source tree whose src/repro_torch is timed")
    ap.add_argument("--tag", default=None, help="a name for the tree in the output")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ssd_ab: no CUDA device", file=sys.stderr)
        return 1
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, os.path.join(tree, "src"))
    from repro_torch.kernels import mamba2_ssd as ssd
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    out = {"tree": args.tag or tree, "shapes": {}}
    for name, (H, P, N) in SHAPES.items():
        args_ = make_case(H, P, N, dev)

        def run(ps=None):
            return lambda: ops.mamba2_ssd(*args_, p_block=ps, out_dtype=torch.float32)

        y, h = run()()
        y_plain, h_plain = ssd.ssd_plain(*args_, out_dtype=torch.float32)
        err = max(float(((y - y_plain).abs() / (1 + y_plain.abs())).max()),
                  float(((h - h_plain).abs() / (1 + h_plain.abs())).max()))
        if not err <= 2e-4:
            print(f"ssd_ab: the kernel disagrees with its plain version at {name} ({err})",
                  file=sys.stderr)
            return 1
        t_eager = [eager_ms(run()) for _ in range(2)]
        t_dev = [device_ms(run()) for _ in range(2)]
        plans = {ps: {"ms": min(eager_ms(run(ps)) for _ in range(2)),
                      "device_ms": min(device_ms(run(ps)) for _ in range(2))}
                 for ps in P_BLOCKS if P % ps == 0}
        out["shapes"][name] = {
            "shape": {"B": 1, "S": SEQ, "H": H, "P": P, "N": N},
            "max_rel_err_vs_plain": err, "ms": min(t_eager), "ms_runs": t_eager,
            "device_ms": min(t_dev), "device_ms_runs": t_dev, "p_blocks": plans}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], stdout=subprocess.PIPE, text=True,
                          check=True).stdout.strip().splitlines()[0]
    out["card"] = card
    print(json.dumps(out), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
