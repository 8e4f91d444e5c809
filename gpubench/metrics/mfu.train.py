"""Model FLOPs of the recorded training steps over the traced window's
seconds at the card's bf16 peak, in percent (``roofline.train_flops``:
6 x the products' parameters a token and the causal attention's forward and
backward; recomputation does not count)."""

from gpubench import harness, roofline


def read(run):
    t, rec = run.trace, run.record
    if t is None or not t.window_s or not rec.get("steps_traced"):
        return None
    train = run.params["train"]
    flops = rec["steps_traced"] * roofline.train_flops(run.dims, train["seq_len"], train["rows"],
                                                       harness.reference(run))
    return roofline.share(flops / roofline.PEAK_BF16_FLOPS, t.window_s)
