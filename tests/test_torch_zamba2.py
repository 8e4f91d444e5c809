"""The zamba2 family (Zyphra's Zamba2-7B, port-only) on the CPU, at its
``REDUCED`` preset, against the benchmark's plain float32 reference
(``gpubench/reference/zamba2.py``, loaded by its path) on the reference's own
seeded random weights, and the reference against ``transformers``'
``Zamba2ForCausalLM`` where that is installed.

Tolerances, each with its reason, and each failed by the reference computed
with its products' operands rounded to float8 (the control, the step below
the configuration's bfloat16):

* ``FP32_TOL`` 1e-4 on logits: the program and the reference compute the
  same float32 function in other orders of summation (measured: about 1e-6;
  the control reads above 0.1);
* ``DECODE_TOL`` 1e-2 where the program decodes through its caches: its conv
  state is kept in bfloat16, as every mamba family's is, so a decoded
  token's conv reads its three predecessors rounded to 8 bits (measured:
  5e-3; the control 0.33).
"""

import dataclasses
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.configs import base, get_config, param_count, reduced_config
from repro_torch.models import Model, param_shapes, split_products
from repro_torch.runtime import Request, ServeConfig, Server, serving

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
from gpubench import harness  # noqa: E402

torch.set_num_threads(1)

FP32_TOL = 1e-4
DECODE_TOL = 1e-2
CELL = "zamba2_7b.prefill_long"


def _reference():
    spec = importlib.util.spec_from_file_location(
        "zamba2_reference", ROOT / "gpubench" / "reference" / "zamba2.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _reference()
CONFIG_FILE = harness.load_json(ROOT / "gpubench" / "configs" / "zamba2_7b.json")


def _setup(seed=11, dtype=torch.float32):
    """The rehearsal's dims in ``dtype``, the port's reduced config in it,
    the reference's weights drawn from ``seed`` and a model holding them."""
    dims = dict(CONFIG_FILE["rehearsal"]["run"], dtype=str(dtype).replace("torch.", ""))
    cfg = dataclasses.replace(reduced_config("zamba2_7b"), dtype=dtype)
    weights = harness.draw_weights(dims, seed, torch.device("cpu"), REF)
    model = Model(cfg, attn_impl="hopper", ssd_impl="hopper", device="cpu")
    model.load_state_dict(weights)
    return dims, cfg, weights, model


def _tokens(S, seed, vocab=256):
    return torch.randint(0, vocab, (S,), generator=torch.Generator().manual_seed(seed))


def _ref_logits(dims, weights, tokens, prompt_len=1, precision="fp32"):
    return REF.served_logits(dims, harness.leaf_reader(weights), [(tokens, prompt_len)],
                             precision)[0]


def _gap(got, want):
    return float((got.float() - want.float()).abs().max())


@pytest.mark.parametrize("impls", [("hopper", "hopper"), ("chunked", "chunked"),
                                   ("xla", "hopper")])
def test_prefill_logits_match_the_reference(impls):
    """Every position's logits of a 40-token prompt (three chunks of the
    scan, the three applications of the two shared blocks), through each
    attention and scan path."""
    dims, cfg, weights, _ = _setup()
    model = Model(cfg, attn_impl=impls[0], ssd_impl=impls[1], device="cpu")
    model.load_state_dict(weights)
    toks = _tokens(40, 3)
    h, _ = model.prefill({"tokens": toks[None]}, max_len=64)
    got = model.logits(h)[0]
    want = _ref_logits(dims, weights, toks)
    assert _gap(got, want) < FP32_TOL
    assert _gap(_ref_logits(dims, weights, toks, precision="fp8"), want) > 10 * FP32_TOL


def test_prefill_then_decode_through_the_caches_matches_the_full_forward():
    """A 27-token prompt, then 13 tokens decoded one at a time through the
    KV caches, SSM and conv states: each step's logits against the
    reference's full forward pass over the whole sequence."""
    dims, cfg, weights, model = _setup(seed=5)
    toks = _tokens(40, 4)
    h, state = model.prefill({"tokens": toks[None, :27]}, max_len=64)
    got = [model.logits(h[:, -1:])[0]]
    for t in range(27, 39):
        h, state = model.decode_step(toks[None, t:t + 1], state)
        got.append(model.logits(h)[0])
    got = torch.cat(got)
    want = _ref_logits(dims, weights, toks, prompt_len=27)[:-1]
    assert got.shape == want.shape == (13, dims["vocab"])
    assert _gap(got, want) < DECODE_TOL
    ctrl = _ref_logits(dims, weights, toks, prompt_len=27, precision="fp8")[:-1]
    assert _gap(ctrl, want) > DECODE_TOL


def test_server_serves_what_the_reference_computes():
    """``Server.serve`` of five requests through two slots (slot recycling),
    greedy: each served token's logit within ``DECODE_TOL`` of the
    reference's best at its position, as the benchmark's check reads it."""
    dims, cfg, weights, _ = _setup(seed=7)
    server = Server(cfg, ServeConfig(batch_slots=2, max_len=64, max_new_tokens=6, eos=-1),
                    weights, device="cpu")
    rng = np.random.default_rng(2)
    reqs = [Request(uid=i, prompt=rng.integers(0, 256, size=n).astype(np.int32))
            for i, n in enumerate((9, 31, 17, 40, 3))]
    done = server.serve(reqs)
    assert [c.uid for c in done] == list(range(5))
    worst = ctrl_worst = 0.0
    for r, c in zip(reqs, done):
        assert len(c.tokens) == 6
        seq = torch.from_numpy(np.concatenate([r.prompt, np.asarray(c.tokens[:-1], np.int32)]))
        want = _ref_logits(dims, weights, seq.long(), prompt_len=len(r.prompt))
        served = torch.tensor(c.tokens)
        worst = max(worst, float((want.max(-1).values - want[torch.arange(6), served]).max()))
        ctrl = _ref_logits(dims, weights, seq.long(), len(r.prompt), "fp8").argmax(-1)
        ctrl_worst = max(ctrl_worst, float((want.max(-1).values - want[torch.arange(6), ctrl]).max()))
    assert worst < DECODE_TOL
    assert ctrl_worst > DECODE_TOL


def test_the_config_is_the_configuration_files():
    """``harness.port_config`` holds the program's config to the file's
    ``run`` block field by field (and its rehearsal's to the preset); the
    ``zamba2`` group, which ``harness.FIELDS`` does not hold, key by key."""
    for rehearse, get in ((False, get_config), (True, reduced_config)):
        run = harness.open_run(ROOT, CELL, 0, False, rehearse)
        cfg = harness.port_config(run)
        assert cfg is get("zamba2_7b")
        group = run.dims["zamba2"]
        assert set(group) == {f.name for f in dataclasses.fields(cfg.zamba2)}
        for key, value in group.items():
            got = getattr(cfg.zamba2, key)
            assert (list(got) if isinstance(got, tuple) else got) == value, key
        assert run.dims["norm_eps"] == 1e-5
    assert CONFIG_FILE["reduced"] == []
    full = get_config("zamba2_7b")
    assert (full.n_layers, full.d_model, full.dh, full.n_heads, full.ssm_heads,
            full.ssm_groups) == (81, 3584, 224, 32, 112, 2)
    assert full.dh == 2 * full.d_model // full.n_heads
    ids = full.zamba2.hybrid_layer_ids
    assert list(ids) == CONFIG_FILE["hybrid_layer_ids"]
    assert [CONFIG_FILE["layers_block_type"][i] == "hybrid" for i in range(81)] == \
        [i in ids for i in range(81)]


def test_port_only_config_stays_out_of_the_reference_lists():
    assert "zamba2_7b" in base.PORT_ONLY_IDS and "zamba2_7b" not in base.ARCH_IDS
    assert "zamba2_7b" not in base.all_configs()
    assert get_config("zamba2-7b") is get_config("zamba2_7b")
    assert all(get_config(a).zamba2 is None for a in base.ARCH_IDS)


@pytest.mark.parametrize("arch", ["zamba2_7b", "zamba2_7b_reduced"])
def test_param_count_is_the_models(arch):
    """``param_count`` counts every leaf of the model: 7.36 B at full width
    (shapes on ``meta``, nothing allocated)."""
    cfg = reduced_config("zamba2_7b") if arch.endswith("reduced") else get_config("zamba2_7b")
    model = Model(cfg, device="cpu", storage="meta")
    n = sum(p.numel() for p in model.parameters())
    assert n == param_count(cfg) == base.active_param_count(cfg)
    assert n == sum(int(np.prod(s)) for s in param_shapes(cfg).values())
    if arch == "zamba2_7b":
        assert n == 7_356_749_648


def test_what_the_family_does_not_do_raises():
    cfg = reduced_config("zamba2_7b")
    model = Model(cfg, device="cpu").init(seed=0)
    toks = _tokens(8, 1)[None]
    with pytest.raises(NotImplementedError, match="E3"):
        model.train_loss({"tokens": toks, "targets": toks})
    with pytest.raises(NotImplementedError, match="model axis wider than 1"):
        split_products(cfg)


def test_server_counts_the_scans_rows(monkeypatch):
    """With telemetry on, ``serve.ssd_scan_tokens`` counts prompt tokens times
    mamba layers, and ``ssd.launches.<plan>`` each prefill's launches by
    plan (on the CPU, counted as the wrapper counts them on the card)."""
    from repro_torch.kernels import mamba2_ssd as ssd
    from repro_torch.kernels import ops

    plain = ops.mamba2_ssd

    def counted(x, dt, a, bm, cm, **kw):
        plan = ssd.choose_plan(x.shape[0], x.shape[2], x.shape[3], bm.shape[-1], torch.bfloat16)
        key = ssd.plan_key(plan)
        ssd.mamba2_ssd.launches_by_plan[key] = ssd.mamba2_ssd.launches_by_plan.get(key, 0) + 1
        return plain(x, dt, a, bm, cm, **kw)

    monkeypatch.setattr(ssd.mamba2_ssd, "launches_by_plan", {})
    monkeypatch.setattr(ops, "mamba2_ssd", counted)
    dims, cfg, weights, _ = _setup(seed=3)
    server = Server(cfg, ServeConfig(batch_slots=2, max_len=64, max_new_tokens=2, eos=-1),
                    weights, device="cpu")
    lens = (5, 12, 30)
    reqs = [Request(uid=i, prompt=np.arange(1, n + 1, dtype=np.int32)) for i, n in enumerate(lens)]
    obs.reset()
    obs.enable()
    try:
        server.serve(reqs)
        snap = obs.metrics().snapshot()
    finally:
        obs.disable()
        obs.reset()
    assert snap["serve.ssd_scan_tokens"] == sum(lens) * cfg.n_layers
    key = ssd.plan_key(ssd.choose_plan(1, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state,
                                       torch.bfloat16))
    assert snap[f"ssd.launches.{key}"] == len(lens) * cfg.n_layers


def test_a_replayed_graph_keeps_the_launches_by_plan():
    """Capture takes back the plans a capture counted, each replay adds what
    it launches: ``launches_by_plan`` equals the launches that ran."""
    from repro_torch.kernels import mamba2_ssd as ssd

    class Graph(serving.StepGraph):
        def _record(self, step):
            return step()

        def _replay(self):
            pass

    saved = ssd.mamba2_ssd.launches_by_plan
    ssd.mamba2_ssd.launches_by_plan = {}
    try:
        def step():
            by_plan = ssd.mamba2_ssd.launches_by_plan
            by_plan["mma.p32"] = by_plan.get("mma.p32", 0) + 3
            return torch.zeros(1)

        graph = Graph(torch.device("cpu"))
        graph.capture(step)
        assert graph.launches == {("mamba2_ssd", "launches_by_plan", "mma.p32"): 3}
        assert ssd.mamba2_ssd.launches_by_plan == {"mma.p32": 0}
        for _ in range(4):
            graph.replay()
        assert ssd.mamba2_ssd.launches_by_plan == {"mma.p32": 12}
    finally:
        ssd.mamba2_ssd.launches_by_plan = saved


def test_reference_counts_every_product():
    """The yardstick's counts: products a token passes through (the shared
    blocks once per application), the tied head, 13 attending applications
    of (32, 32, 224), and the scan's and conv's work."""
    run = CONFIG_FILE["run"]
    shapes = param_shapes(get_config("zamba2_7b"))
    products = [n for n in shapes if n in ("mamba.in_proj", "mamba.out_proj")]
    mamba = sum(int(np.prod(shapes[n])) for n in products)
    block = sum(int(np.prod(shapes[n][1:])) for n in shapes
                if n.startswith("shared.w"))
    apps = sum(int(np.prod(shapes[n][1:])) for n in shapes if n.startswith("apps."))
    assert REF.body_params(run) == mamba + 13 * (block + apps)
    assert REF.head_params(run) == 3584 * 32000
    assert REF.attention_layers(run) == [(32, 32, 224)] * 13
    assert REF.token_flops(run) == 81 * 5_629_952
    layout = REF.layout(run)
    assert {n: s for n, (s, _) in layout.items()} == dict(shapes)


def test_reference_matches_transformers_zamba2():
    """The reference against ``transformers``' ``Zamba2ForCausalLM`` (eager
    attention, its plain-PyTorch mamba path) at the rehearsal's sizes with the
    same weights: every position's logits of a 37-token prompt within
    ``FP32_TOL``.  Weights map as ``transformers`` lays them: products
    transposed, norm weights ``1 + w``, the conv's taps ``(C, 1, 4)``.  Its
    scan is given one chunk (64 rows; the reference walks 16-row chunks):
    ``transformers`` 4.57's plain-PyTorch scan sums the inter-chunk decays
    over the wrong axis, so its multi-chunk result is not the SSD's (its
    CUDA path, and the published model's, do not use it).  ``time_step_min``
    is set below any ``dt`` here, as the reference does not clamp ``dt``
    (the published CUDA path does not)."""
    transformers = pytest.importorskip("transformers")
    dims = dict(CONFIG_FILE["rehearsal"]["run"], dtype="float32")
    z, L = dims["zamba2"], dims["n_layers"]
    kinds = ["hybrid" if i in z["hybrid_layer_ids"] else "mamba" for i in range(L)]
    hcfg = transformers.Zamba2Config(
        vocab_size=dims["vocab"], hidden_size=dims["d_model"], num_hidden_layers=L,
        layers_block_type=kinds, mamba_d_state=dims["ssm_state"], mamba_d_conv=4,
        mamba_expand=2, mamba_ngroups=z["ssm_groups"], n_mamba_heads=dims["ssm_heads"],
        chunk_size=64, intermediate_size=dims["d_ff"], hidden_act=z["activation"],
        num_attention_heads=dims["n_heads"], num_mem_blocks=z["mem_blocks"],
        adapter_rank=z["adapter_rank"], use_mem_rope=True, use_shared_attention_adapter=False,
        rope_theta=dims["rope_theta"], rms_norm_eps=dims["norm_eps"], time_step_min=1e-30,
        max_position_embeddings=128, tie_word_embeddings=True, attn_implementation="eager")
    assert hcfg.attention_head_dim == dims["head_dim"]
    assert hcfg.mamba_headdim == dims["ssm_head_dim"]
    torch.manual_seed(0)
    hf = transformers.Zamba2ForCausalLM(hcfg).eval()
    w = harness.draw_weights(dims, 5, torch.device("cpu"), REF)
    m = hf.model
    with torch.no_grad():
        m.embed_tokens.weight.copy_(w["embed"])
        m.final_layernorm.weight.copy_(1 + w["final_ln"])
        for i, layer in enumerate(m.layers):
            dec = layer.mamba_decoder if kinds[i] == "hybrid" else layer
            mx = dec.mamba
            mx.in_proj.weight.copy_(w["mamba.in_proj"][i].T)
            mx.conv1d.weight.copy_(w["mamba.conv_w"][i].T[:, None, :])
            mx.conv1d.bias.copy_(w["mamba.conv_b"][i])
            mx.A_log.copy_(w["mamba.a_log"][i])
            mx.D.copy_(w["mamba.d_skip"][i])
            mx.dt_bias.copy_(w["mamba.dt_bias"][i])
            mx.norm.weight.copy_(1 + w["mamba.norm"][i])
            mx.out_proj.weight.copy_(w["mamba.out_proj"][i].T)
            dec.input_layernorm.weight.copy_(1 + w["mamba.ln"][i])
        for j, lid in enumerate(z["hybrid_layer_ids"]):
            layer, b = m.layers[lid], j % z["mem_blocks"]
            st = layer.shared_transformer
            assert st.block_id == b
            layer.linear.weight.copy_(w["apps.linear"][j].T)
            st.input_layernorm.weight.copy_(1 + w["shared.ln1"][b])
            st.pre_ff_layernorm.weight.copy_(1 + w["shared.ln2"][b])
            for n in "qkvo":
                getattr(st.self_attn, f"{n}_proj").weight.copy_(w[f"shared.w{n}"][b].T)
            st.feed_forward.gate_up_proj.weight.copy_(w["shared.w_gate_up"][b].T)
            st.feed_forward.down_proj.weight.copy_(w["shared.w_down"][b].T)
            adapter = st.feed_forward.gate_up_proj_adapter_list[j]
            adapter[0].weight.copy_(w["apps.lora_a"][j].T)
            adapter[1].weight.copy_(w["apps.lora_b"][j].T)
        assert hf.lm_head.weight.data_ptr() == m.embed_tokens.weight.data_ptr()
        toks = _tokens(37, 1, dims["vocab"])
        want = hf(input_ids=toks[None], use_cache=False).logits[0]
    got = _ref_logits(dims, w, toks)
    assert _gap(got, want) < FP32_TOL
    assert _gap(_ref_logits(dims, w, toks, precision="fp8"), want) > 10 * FP32_TOL
