"""The port's ``Server`` against the JAX package's, on the CPU.

The five requests of ``tests/test_runtime.py::test_server_continuous_batching``
go through both servers with the same float32 weights (made with numpy from a
seed and carried across), for the dense family and for the ssm and hybrid
families (reduced mamba2_370m and zamba2_2_7b, through both kernels' paths).
Per-step logits must agree within 1e-4, and the greedy tokens must be equal
wherever the reference's top-2 margin exceeds twice the two runs' difference
at that step (below it, either choice is right and the runs may part).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.runtime import ServeConfig as JServeConfig
from repro.runtime import Server as JServer
from repro.runtime.serving import Request as JRequest
from repro_torch import convert, obs
from repro_torch.models import param_shapes
from repro_torch.runtime import Completion, Request, ServeConfig, Server

torch.set_num_threads(1)

TOL = 1e-4
SERVE = dict(batch_slots=2, max_len=32, max_new_tokens=4, eos=-1)


def _weights(tcfg, seed=0):
    rng = np.random.default_rng(seed)
    flat = {}
    for name, shape in param_shapes(tcfg).items():
        leaf = name.rsplit(".", 1)[-1]
        noise = rng.standard_normal(shape)
        if leaf == "a_log":      # mamba: decays around the reference's init
            decays = np.log(np.linspace(1.0, 16.0, shape[-1]))
            flat[name] = (decays + 0.1 * noise).astype(np.float32)
            continue
        if leaf == "d_skip":
            flat[name] = (1.0 + 0.1 * noise).astype(np.float32)
            continue
        if leaf.startswith(("ln", "b")) or leaf in ("final_ln", "norm", "conv_b", "dt_bias"):
            std = 0.1
        elif leaf == "conv_w":
            std = 0.2
        else:
            std = 0.02 if leaf == "embed" else 1.0 / math.sqrt(shape[-2])
        flat[name] = (noise * std).astype(np.float32)
    return convert.params_to_reference({k: torch.from_numpy(v) for k, v in flat.items()})


def _servers(arch="stablelm_3b", attn_impl="hopper", ssd_impl="hopper", **serve_kw):
    kw = dict(SERVE, **serve_kw)
    tcfg = dataclasses.replace(tconfigs.reduced_config(arch), dtype=torch.float32)
    jcfg = dataclasses.replace(jconfigs.reduced_config(arch), dtype=jnp.float32)
    tree = _weights(tcfg)
    jparams = jax.tree.map(jnp.asarray, tree)
    server = Server(tcfg, ServeConfig(**kw), convert.params_from_reference(tree, tcfg, "cpu"),
                    device="cpu", attn_impl=attn_impl, ssd_impl=ssd_impl)
    return server, JServer(jcfg, JServeConfig(**kw), jparams)


def _record(server, is_jax):
    """Wrap the two step functions so that every call's logits are kept."""
    calls = []

    def wrap(fn, kind):
        def wrapped(*args):
            logits, state = fn(*args)
            arr = np.asarray(logits) if is_jax else logits.float().numpy()
            calls.append((kind, arr.copy()))
            return logits, state
        return wrapped

    server._prefill = wrap(server._prefill, "prefill")
    server._decode = wrap(server._decode, "decode")
    return calls


def _requests(cls):
    return [cls(uid=i, prompt=np.arange(1, 5 + i, dtype=np.int32)) for i in range(5)]


def _compare_runs(calls, jcalls, done, jdone, tol=TOL):
    """Logits step for step while the two runs are fed the same tokens: each
    step within ``tol``; the greedy choices equal unless the reference's top-2
    margin is within twice the step's largest difference (a near tie, where
    they may part and the comparison stops)."""
    assert [k for k, _ in calls] == [k for k, _ in jcalls]
    compared = 0
    for (kind, got), (_, want) in zip(calls, jcalls):
        np.testing.assert_allclose(got, want, atol=tol, rtol=tol, err_msg=f"{kind} #{compared}")
        compared += 1
        top2 = np.sort(want, axis=-1)[:, -2:]
        if float((top2[:, 1] - top2[:, 0]).min()) <= 2 * float(np.abs(got - want).max()):
            return compared, False    # a near tie: the greedy choices may part here
        assert (got.argmax(-1) == want.argmax(-1)).all()
    assert [c.tokens for c in done] == [c.tokens for c in jdone]
    return compared, True


@pytest.mark.parametrize("attn_impl", ["hopper", "chunked"])
def test_server_matches_reference_on_continuous_batching(attn_impl):
    server, jserver = _servers(attn_impl=attn_impl)
    calls, jcalls = _record(server, False), _record(jserver, True)
    done = server.serve(_requests(Request))
    jdone = jserver.serve(_requests(JRequest))
    assert [c.uid for c in done] == [c.uid for c in jdone] == [0, 1, 2, 3, 4]
    assert [len(c.tokens) for c in done] == [len(c.tokens) for c in jdone] == [4] * 5
    assert all(isinstance(c, Completion) and c.latency_s > 0 for c in done)
    compared, to_the_end = _compare_runs(calls, jcalls, done, jdone)
    assert compared >= 5, "the runs parted before the first decode step"
    # with these weights no step is a near tie: the token lists are equal
    assert to_the_end


@pytest.mark.parametrize("arch", ["mamba2_370m", "zamba2_2_7b"])
@pytest.mark.parametrize("ssd_impl", ["hopper", "chunked"])
def test_server_matches_reference_on_ssm_and_hybrid(arch, ssd_impl):
    """Reduced mamba2_370m (SSM state, conv state, no KV cache) and zamba2_2_7b
    (both, and the shared attention block's stacked KV cache) through slot
    recycling: the reference's greedy token lists, logits within 1e-4 a step."""
    server, jserver = _servers(arch=arch, ssd_impl=ssd_impl)
    calls, jcalls = _record(server, False), _record(jserver, True)
    done = server.serve(_requests(Request))
    jdone = jserver.serve(_requests(JRequest))
    assert [c.uid for c in done] == [c.uid for c in jdone] == [0, 1, 2, 3, 4]
    compared, to_the_end = _compare_runs(calls, jcalls, done, jdone)
    assert compared >= 5, "the runs parted before the first decode step"
    assert to_the_end
    assert [c.tokens for c in done] == [c.tokens for c in jdone]


def test_server_matches_reference_with_gqa_and_windows():
    """gemma3 reduced: one kv head, local windows, two thetas, tied head."""
    server, jserver = _servers(arch="gemma3_1b")
    calls, jcalls = _record(server, False), _record(jserver, True)
    done = server.serve(_requests(Request))
    jdone = jserver.serve(_requests(JRequest))
    compared, _ = _compare_runs(calls, jcalls, done, jdone)
    assert compared >= 5


def test_slot_recycling():
    """5 requests through 2 slots: 5 prefills, every request served once, and
    the decode batch stays at 2 slots whatever is pending."""
    server, _ = _servers()
    calls = _record(server, False)
    done = server.serve(_requests(Request))
    kinds = [k for k, _ in calls]
    assert kinds.count("prefill") == 5
    assert kinds[:2] == ["prefill", "prefill"] and kinds[2] == "decode"
    assert all(arr.shape == ((1, 256) if k == "prefill" else (2, 256)) for k, arr in calls)
    assert sorted(c.uid for c in done) == [0, 1, 2, 3, 4]
    # fewer requests than slots: the free slot is decoded too and drops out
    server2, _ = _servers()
    one = server2.serve([Request(uid=7, prompt=np.arange(1, 6, dtype=np.int32))])
    assert [c.uid for c in one] == [7] and len(one[0].tokens) == 4
    assert server2.serve([]) == []


def test_eos_ends_a_sequence_early():
    server, _ = _servers()
    first = server.serve(_requests(Request))
    eos = first[0].tokens[1]
    server2, _ = _servers(eos=eos)
    done = server2.serve(_requests(Request))
    assert done[0].tokens == first[0].tokens[:2]


def test_temperature_sampling_follows_the_numpy_seed():
    server, jserver = _servers(temperature=0.7, seed=11)
    done = server.serve(_requests(Request))
    jdone = jserver.serve(_requests(JRequest))
    # same logits (1e-4) and the same numpy draws: the same tokens, unless a
    # draw lands within that tolerance of a bin edge
    assert [c.tokens for c in done] == [c.tokens for c in jdone]
    again, _ = _servers(temperature=0.7, seed=11)
    assert [c.tokens for c in again.serve(_requests(Request))] == [c.tokens for c in done]
    other, _ = _servers(temperature=0.7, seed=12)
    assert [c.tokens for c in other.serve(_requests(Request))] != [c.tokens for c in done]


def test_metrics_snapshot_and_telemetry():
    server, jserver = _servers()
    assert server.metrics_snapshot()["tokens_per_s"] == 0.0
    obs.reset()
    obs.enable()
    try:
        server.serve(_requests(Request))
    finally:
        obs.disable()
    jserver.serve(_requests(JRequest))
    snap, jsnap = server.metrics_snapshot(), jserver.metrics_snapshot()
    assert sorted(snap) == sorted(jsnap) == ["completions", "latency_ms", "tokens", "tokens_per_s"]
    assert sorted(snap["latency_ms"]) == sorted(jsnap["latency_ms"])
    assert (snap["completions"], snap["tokens"]) == (jsnap["completions"], jsnap["tokens"]) == (5, 20)
    assert snap["tokens_per_s"] > 0 and snap["latency_ms"]["p99"] >= snap["latency_ms"]["p50"] > 0
    spans = [e for e in obs.get_telemetry().events if e.name == "serve"]
    assert len(spans) == 1 and spans[0].attrs == {"requests": 5, "completions": 5}
    # the Server's counters: 30 prompt tokens; 9 decode steps of 2 rows (3 a
    # request, the fifth alone), 15 of them busy (20 tokens, 5 from prefills);
    # the model's stacked group unbound once a forward (5 prefills, 9 steps)
    assert obs.metrics().snapshot() == {"serve.prefill_tokens": 30, "serve.decode_rows": 18,
                                        "serve.busy_rows": 15, "params.stacks_unbound": 14}
    assert '"serve"' in obs.to_jsonl() and obs.chrome_trace()["traceEvents"][0]["name"] == "serve"
    obs.reset()


def test_prompt_past_max_len_raises():
    server, _ = _servers(max_len=8)
    with pytest.raises(ValueError, match="KV cache of length 8"):
        server.serve([Request(uid=0, prompt=np.arange(1, 12, dtype=np.int32))])
    # 6 prompt tokens + 3 decode inserts overrun a cache of 8
    with pytest.raises(ValueError, match="KV cache of length 8"):
        server.serve([Request(uid=0, prompt=np.arange(1, 7, dtype=np.int32))])
    ok, _ = _servers(max_len=9)
    assert len(ok.serve([Request(uid=0, prompt=np.arange(1, 7, dtype=np.int32))])[0].tokens) == 4


def test_set_slot_writes_in_place_on_the_batch_axis():
    full = {"kv": (torch.zeros(2, 3, 4, 1, 2), torch.zeros(2, 3, 4, 1, 2)),
            "pos": torch.zeros(3, dtype=torch.int32)}
    one = {"kv": (torch.ones(2, 1, 4, 1, 2), 2 * torch.ones(2, 1, 4, 1, 2)),
           "pos": torch.tensor([5], dtype=torch.int32)}
    kept = full["kv"][0]
    Server._map_state2(lambda f, o, ax: Server._set_slot(f, o, 1, ax), full, one)
    assert full["kv"][0] is kept
    assert full["pos"].tolist() == [0, 5, 0]
    assert float(full["kv"][0][:, 1].min()) == 1.0 and float(full["kv"][1][:, 1].min()) == 2.0
    assert float(full["kv"][0][:, 0].abs().max()) == 0.0 == float(full["kv"][0][:, 2].abs().max())
    spread = Server._map_state(lambda x, ax: x.repeat_interleave(3, dim=ax), one)
    assert spread["kv"][0].shape == (2, 3, 4, 1, 2) and spread["pos"].tolist() == [5, 5, 5]
    assert Server._BATCH_AXIS == JServer._BATCH_AXIS


def test_server_adopts_float32_leaves_as_float32():
    """A bfloat16 mamba model keeps a_log / d_skip / dt_bias in float32, as the
    reference does; the server adopts them as they are, without a copy."""
    tcfg = tconfigs.reduced_config("mamba2_370m")
    state = convert.params_from_reference(_weights(tcfg), tcfg, "cpu")
    server = Server(tcfg, ServeConfig(**SERVE), state, device="cpu")
    for leaf in ("a_log", "d_skip", "dt_bias"):
        assert server.model.mamba[leaf].dtype == torch.float32
        assert server.model.mamba[leaf].data_ptr() == state[f"mamba.{leaf}"].data_ptr()
    assert server.model.mamba["in_proj"].dtype == torch.bfloat16
    assert server.model.ssd_impl == "hopper"
    # float32 leaves handed over in bfloat16 are brought back to float32
    rounded = {k: v.bfloat16() for k, v in state.items()}
    assert Server(tcfg, ServeConfig(**SERVE), rounded, device="cpu").model.mamba["a_log"].dtype == \
        torch.float32


def test_server_adopts_weights_without_copying():
    tcfg = dataclasses.replace(tconfigs.reduced_config("stablelm_3b"), dtype=torch.float32)
    state = convert.params_from_reference(_weights(tcfg), tcfg, "cpu")
    server = Server(tcfg, ServeConfig(**SERVE), state, device="cpu")
    assert server.model.layers["wq"].data_ptr() == state["layers.wq"].data_ptr()
    assert server.model.attn_impl == "hopper"
