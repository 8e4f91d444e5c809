#!/usr/bin/env python3
"""The SSD kernel's outputs of one source tree, saved, or held bit for bit
against another tree's.

    python3 tools/ssd_bitwise.py --tree DIR --save A.pt      # DIR's kernel
    python3 tools/ssd_bitwise.py --against A.pt              # this tree's, compared

The wrapper is imported from ``DIR/src`` and its kernel built there, so one
card can compare two commits (unpack the other with ``git archive`` into a
directory that ``.gitignore`` lists).  The cases are one group of B / C, the
call both trees take: mamba2_370m's and zamba2_2_7b's mamba layer (512 and
2,048 tokens, the model's layout, bf16 on the mma path with y in fp32 and
fp32 on the fma path), each ``p_block``, from zero and from a carried state.
``--against`` prints one JSON line, each case ``true`` where y and the last
state are the same bits, and exits 1 unless all are.  Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

SHAPES = {"mamba2_370m": (32, 64, 128), "zamba2_2_7b": (80, 64, 64)}


def cases(dev):
    for model, (H, P, N) in SHAPES.items():
        for S in (512, 2048):
            rng = np.random.default_rng(S)
            xbc = torch.from_numpy(rng.standard_normal((1, S, H * P + 2 * N), dtype=np.float32)
                                   * 0.5).to(dev)
            dt = torch.nn.functional.softplus(torch.from_numpy(
                rng.standard_normal((1, S, H), dtype=np.float32)).to(dev))
            a = -torch.linspace(1.0, 16.0, H, device=dev)
            h0 = torch.from_numpy(rng.standard_normal((1, H, P, N), dtype=np.float32)
                                  * 0.3).to(dev)
            for dtype in (torch.bfloat16, torch.float32):
                t = xbc.to(dtype)
                x = t[..., :H * P].reshape(1, S, H, P)
                bm, cm = t[..., H * P:H * P + N], t[..., H * P + N:]
                for ps in (16, 32, 64):
                    for start in (None, h0):
                        name = (f"{model} S={S} {str(dtype)[6:]} p_block={ps} "
                                f"{'h0' if start is not None else 'zero'}")
                        yield name, (x, dt, a, bm, cm), dict(h0=start, p_block=ps,
                                                              out_dtype=torch.float32)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--save", default=None)
    ap.add_argument("--against", default=None)
    args = ap.parse_args(argv)
    os.environ["REPRO_TORCH_BUILD_DIR"] = os.path.join(args.tree, "build", "repro_torch")
    sys.path.insert(0, os.path.join(args.tree, "src"))
    from repro_torch.kernels import mamba2_ssd as ssd

    dev = torch.device("cuda")
    out = {}
    for name, inputs, kw in cases(dev):
        y, h = ssd.mamba2_ssd(*inputs, **kw)
        out[name] = (y.cpu(), h.cpu())
    torch.cuda.synchronize()
    if args.save:
        torch.save(out, args.save)
        print(json.dumps({"saved": args.save, "cases": len(out)}))
        return 0
    theirs = torch.load(args.against)
    same = {k: bool(torch.equal(v[0], theirs[k][0]) and torch.equal(v[1], theirs[k][1]))
            for k, v in out.items()}
    print(json.dumps({"bit_for_bit": all(same.values()), "cases": len(same), "by_case": same}))
    return 0 if all(same.values()) and set(same) == set(theirs) else 1


if __name__ == "__main__":
    sys.exit(main())
