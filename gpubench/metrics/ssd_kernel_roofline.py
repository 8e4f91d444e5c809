"""The SSD kernel's share of its roofline, in percent: the least time the
card could take for the SSD launches that the recorded calls' prompts need
(one launch a mamba layer a prompt: decode runs no kernel), over the device
time of the kernel's launches (``mamba2_ssd*``) summed by name from the
trace.

A launch's least time is the larger of its operations at the bf16 peak and
its bytes at the memory's peak.  Operations: the chunked dual form at the
configuration's chunk ``Q`` (``ssm_chunk``), per token the scores ``C Bᵀ``
(``2 G Q N``), their product with ``dt x`` (``2 H Q P``), ``C hᵀ``
(``2 H P N``) and the state update (``2 H P N``).  Bytes, each read or
written once: ``x`` (bf16), ``dt`` (float32), ``B`` and ``C`` (bf16, ``G``
groups), ``y`` (float32, as the model asks for it) a token, and the final
state (float32) once a launch.  A configuration without SSM heads reads
nothing here."""

from gpubench import harness, roofline

#: bytes of the launch's element types, as the program calls the kernel
BF16, FP32 = 2, 4


def groups(dims) -> int:
    """B / C groups: the ``zamba2`` group's, else one."""
    return dims["zamba2"]["ssm_groups"] if dims.get("zamba2") else 1


def launch_flops(dims, tokens: int) -> int:
    H, P, N, Q = dims["ssm_heads"], dims["ssm_head_dim"], dims["ssm_state"], dims["ssm_chunk"]
    G = groups(dims)
    return tokens * (2 * G * Q * N + H * (2 * Q * P + 4 * P * N))


def launch_bytes(dims, tokens: int) -> int:
    H, P, N = dims["ssm_heads"], dims["ssm_head_dim"], dims["ssm_state"]
    G = groups(dims)
    per_token = H * P * BF16 + H * FP32 + 2 * G * N * BF16 + H * P * FP32
    return tokens * per_token + H * P * N * FP32


def serve_ssd_seconds(dims, requests) -> float:
    """The least time of every SSD launch of ``requests`` (``(prompt_len,
    tokens served)``): ``n_layers`` launches a prompt."""
    return dims["n_layers"] * sum(
        roofline.least_seconds(launch_flops(dims, p), launch_bytes(dims, p)) for p, _ in requests)


def read(run):
    t, rec = run.trace, run.record
    if t is None or not rec.get("served_traced") or not run.dims.get("ssm_heads"):
        return None
    kernel = t.kernel_seconds("mamba2_ssd")
    return roofline.share(serve_ssd_seconds(run.dims, rec["served_traced"]), kernel)
