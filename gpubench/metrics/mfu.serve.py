"""Model FLOPs of the recorded calls' useful serving work over the traced
window's seconds at the card's bf16 peak, in percent: each prompt's prefill
and each served token's decode (``roofline.serve_flops``); free slots and
work thrown away do not count."""

from gpubench import harness, roofline


def read(run):
    t, rec = run.trace, run.record
    if t is None or not t.window_s or not rec.get("served_traced"):
        return None
    ref = harness.reference(run)
    flops = sum(roofline.serve_flops(run.dims, p, n, ref) for p, n in rec["served_traced"])
    return roofline.share(flops / roofline.PEAK_BF16_FLOPS, t.window_s)
