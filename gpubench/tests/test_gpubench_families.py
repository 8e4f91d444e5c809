"""What a configuration brings of its own, on the CPU: the reference module
its file names (the layout and the yardstick's counts, frozen for the two
configurations the benchmark had before references were pluggable), and the
program's configuration held to the file field by field."""

import dataclasses

import pytest

from gpubench import harness, roofline

#: ``(name, shape, std)`` of every leaf in drawing order: leaf ``i`` is drawn
#: from a generator seeded from ``i``, so another order draws other weights
LAYOUT = {
    "stablelm_3b": [
        ("embed", (50304, 2560), 0.02),
        ("layers.ln1", (32, 2560), 0.02),
        ("layers.ln2", (32, 2560), 0.02),
        ("layers.wq", (32, 2560, 2560), 0.01976423537605237),
        ("layers.wk", (32, 2560, 2560), 0.01976423537605237),
        ("layers.wv", (32, 2560, 2560), 0.01976423537605237),
        ("layers.wo", (32, 2560, 2560), 0.01976423537605237),
        ("layers.w_gate", (32, 2560, 6912), 0.01976423537605237),
        ("layers.w_up", (32, 2560, 6912), 0.01976423537605237),
        ("layers.w_down", (32, 6912, 2560), 0.012028130608117204),
        ("final_ln", (2560,), 0.02),
        ("lm_head", (2560, 50304), 0.01976423537605237),
    ],
    "qwen2_moe_a2_7b": [
        ("embed", (151936, 2048), 0.02),
        ("layers.ln1", (24, 2048), 0.02),
        ("layers.ln2", (24, 2048), 0.02),
        ("layers.wq", (24, 2048, 2048), 0.02209708691207961),
        ("layers.wk", (24, 2048, 2048), 0.02209708691207961),
        ("layers.wv", (24, 2048, 2048), 0.02209708691207961),
        ("layers.wo", (24, 2048, 2048), 0.02209708691207961),
        ("layers.bq", (24, 2048), 0.02),
        ("layers.bk", (24, 2048), 0.02),
        ("layers.bv", (24, 2048), 0.02),
        ("layers.router", (24, 2048, 60), 0.02209708691207961),
        ("layers.we_gate", (24, 60, 2048, 1408), 0.02209708691207961),
        ("layers.we_up", (24, 60, 2048, 1408), 0.02209708691207961),
        ("layers.we_down", (24, 60, 1408, 2048), 0.026650089544451305),
        ("layers.ws_gate", (24, 2048, 5632), 0.02209708691207961),
        ("layers.ws_up", (24, 2048, 5632), 0.02209708691207961),
        ("layers.ws_down", (24, 5632, 2048), 0.013325044772225653),
        ("layers.ws_g", (24, 2048, 1), 0.02209708691207961),
        ("final_ln", (2048,), 0.02),
        ("lm_head", (2048, 151936), 0.02209708691207961),
    ],
}
#: ``(prompt, served) -> serve_flops``, ``(seq_len, rows) -> train_flops`` and
#: ``serve_attention_seconds`` over :data:`REQUESTS` in a 4,096-position
#: cache, as the yardstick gave them before the counts moved into the
#: reference modules
SERVE_FLOPS = {
    "stablelm_3b": {(10, 3): 61699522560, (2048, 32): 11267887595520,
                    (300, 256): 2933177057280},
    "qwen2_moe_a2_7b": {(10, 3): 51480625152, (2048, 32): 9037918011392,
                        (300, 256): 2483572473856},
}
TRAIN_FLOPS = {
    "stablelm_3b": {(8, 2): 256038666240, (4096, 1): 73776129638400, (64, 3): 3077748817920},
    "qwen2_moe_a2_7b": {(8, 2): 228307501056, (4096, 1): 63384858918912,
                        (64, 3): 2742860906496},
}
REQUESTS = [(1024, 32), (2048, 32), (3840, 32), (64, 256), (256, 256), (1, 1)]
ATTENTION_SECONDS = {"stablelm_3b": 0.039027384569575184,
                     "qwen2_moe_a2_7b": 0.023430691584730184}
CELL = {"stablelm_3b": "stablelm_3b.prefill_heavy",
        "qwen2_moe_a2_7b": "qwen2_moe_a2_7b.decode_heavy"}


@pytest.mark.parametrize("config", sorted(LAYOUT))
def test_the_yardstick_of_each_configuration_is_unchanged(config):
    """Through the module the configuration file names, as a run loads it."""
    run = harness.open_run(harness.ROOT, CELL[config], 0, False, False)
    ref = harness.reference(run)
    assert run.config["reference"] == "model"
    got = [(name, tuple(shape), std) for name, (shape, std) in ref.layout(run.dims).items()]
    assert got == LAYOUT[config]
    for (prompt, served), flops in SERVE_FLOPS[config].items():
        assert roofline.serve_flops(run.dims, prompt, served, ref) == flops
    for (seq_len, rows), flops in TRAIN_FLOPS[config].items():
        assert roofline.train_flops(run.dims, seq_len, rows, ref) == flops
    assert roofline.serve_attention_seconds(run.dims, 4096, REQUESTS, ref) == \
        ATTENTION_SECONDS[config]


def test_the_dense_reference_refuses_what_it_does_not_model():
    run = harness.load_json(harness.GPUBENCH / "configs" / "stablelm_3b.json")["run"]
    with pytest.raises(ValueError, match="tie_embeddings"):
        harness.reference_module("model").layout(dict(run, tie_embeddings=True))


# -- the program's configuration held to the file ---------------------------------

#: files as a state-space configuration would state them: the program's
#: smoke-test sizes, a tied head, the SSM sizes and the attention period
SSM_FILES = {
    "zamba2_smoke": {
        "port_config": "zamba2_2_7b", "family": "hybrid",
        "rehearsal": {"port_config": "zamba2_smoke", "run": {
            "n_layers": 6, "d_model": 64, "n_heads": 4, "n_kv_heads": 4, "head_dim": 16,
            "d_ff": 128, "vocab": 256, "rope_theta": 10000.0, "dtype": "bfloat16", "moe": None,
            "tie_embeddings": True, "ssm_state": 16, "ssm_heads": 4, "ssm_head_dim": 16,
            "ssm_chunk": 16, "attn_period": 3}}},
    "mamba2_smoke": {
        "port_config": "mamba2_370m", "family": "ssm",
        "rehearsal": {"port_config": "mamba2_smoke", "run": {
            "n_layers": 2, "d_model": 64, "n_heads": 0, "n_kv_heads": 0, "d_ff": 0,
            "vocab": 256, "dtype": "bfloat16", "tie_embeddings": True, "ssm_state": 16,
            "ssm_heads": 4, "ssm_head_dim": 16, "ssm_chunk": 16}}},
}
#: each stated field, moved away from the program's value
CHANGED = {"tie_embeddings": False, "ssm_state": 32, "ssm_heads": 8, "ssm_head_dim": 32,
           "ssm_chunk": 32, "attn_period": 2}


def rehearsal_run(config):
    return harness.Run({}, {}, {}, config, 0, False, True)


def changed(config, **block):
    return dict(config, rehearsal=dict(config["rehearsal"], run=block))


@pytest.mark.parametrize("name", sorted(SSM_FILES))
def test_port_config_takes_a_tied_head_and_ssm_sizes(name):
    assert harness.port_config(rehearsal_run(SSM_FILES[name])).name == name


@pytest.mark.parametrize("field", sorted(CHANGED))
@pytest.mark.parametrize("name", sorted(SSM_FILES))
def test_port_config_refuses_a_changed_field(name, field):
    config = SSM_FILES[name]
    block = dict(config["rehearsal"]["run"], **{field: CHANGED[field]})
    with pytest.raises(SystemExit, match=field):
        harness.port_config(rehearsal_run(changed(config, **block)))


@pytest.mark.parametrize("name", sorted(SSM_FILES))
def test_port_config_refuses_another_family(name):
    with pytest.raises(SystemExit, match="family"):
        harness.port_config(rehearsal_run(dict(SSM_FILES[name], family="dense")))


@pytest.mark.parametrize("field", ["tie_embeddings", "ssm_state", "ssm_chunk"])
def test_port_config_refuses_a_field_the_file_leaves_out(field):
    """The program's value is not the default, and the file does not state it."""
    config = SSM_FILES["zamba2_smoke"]
    block = {k: v for k, v in config["rehearsal"]["run"].items() if k != field}
    with pytest.raises(SystemExit, match=field):
        harness.port_config(rehearsal_run(changed(config, **block)))


@pytest.mark.parametrize("field,value", [
    ("tie_embeddings", True), ("global_period", 2), ("window", 64), ("attn_chunk", 128),
    ("nope_on_global", True), ("local_rope_theta", 10000.0), ("mrope", True), ("ssm_state", 16),
    ("attn_period", 2), ("qkv_bias", True), ("d_ff", 96), ("family", "hybrid")])
def test_port_config_refuses_a_program_edit(monkeypatch, field, value):
    """A later edit of the program's config shows: a field the file leaves
    out away from its default, or one it states changed."""
    from repro_torch.configs import stablelm_3b

    config = harness.load_json(harness.GPUBENCH / "configs" / "stablelm_3b.json")
    assert harness.port_config(rehearsal_run(config)).name == "stablelm_3b_smoke"
    monkeypatch.setattr(stablelm_3b, "REDUCED",
                        dataclasses.replace(stablelm_3b.REDUCED, **{field: value}))
    with pytest.raises(SystemExit, match=field):
        harness.port_config(rehearsal_run(config))
