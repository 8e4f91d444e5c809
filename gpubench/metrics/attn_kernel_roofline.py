"""The attention kernel's share of its roofline, in percent: the least time
the card could take for every attention launch that the recorded calls'
requests need (visible pairs and K / V rows only,
``roofline.serve_attention_seconds``), over the device time of the kernel's
launches (``flash_attention*``) summed by name from the trace."""

from gpubench import harness, roofline


def read(run):
    t, rec = run.trace, run.record
    if t is None or not rec.get("served_traced"):
        return None
    kernel = t.kernel_seconds("flash_attention")
    least = roofline.serve_attention_seconds(run.dims, rec["max_len"], rec["served_traced"],
                                             harness.reference(run))
    return roofline.share(least, kernel)
