"""The plain reference against the program at the rehearsal sizes, on the CPU,
in float32: the forward pass (dense; MoE on its exact and capacity paths),
the served positions, and the training loss and gradients.  These tests may
import the program; the reference itself never does."""

import dataclasses

import pytest
import torch

from gpubench import harness
from gpubench.reference import model as ref
from gpubench.reference import train as ref_train


def dims_and_model(config: str, skew: bool = False):
    """``skew``: every embedding row shares a direction that the router's
    expert 0 reads, so that most tokens pick it and the capacity rule drops."""
    from repro_torch.configs import base
    from repro_torch.models import Model

    cfile = harness.load_json(harness.GPUBENCH / "configs" / f"{config}.json")
    dims = dict(cfile["rehearsal"]["run"], dtype="float32")
    cfg = dataclasses.replace(base.reduced_config(cfile["port_config"]), dtype=torch.float32)
    weights = harness.draw_weights(dims, 11, torch.device("cpu"))
    if skew:
        c = torch.randn(dims["d_model"], generator=torch.Generator().manual_seed(2))
        weights["embed"] += 3 * c
        weights["layers.router"][:, :, 0] += c / c.norm() * 3
    model = Model(cfg, attn_impl="xla", device="cpu")
    model.load_state_dict(weights)
    return dims, cfg, weights, model


@pytest.mark.parametrize("config,S", [("stablelm_3b", 40), ("qwen2_moe_a2_7b", 200),
                                      ("qwen2_moe_a2_7b", 300)])
def test_forward_matches_the_program(config, S):
    """A whole-sequence forward pass: every position's logits.  qwen2_moe at
    300 tokens routes through the capacity path and drops assignments."""
    from repro_torch.models import transformer

    dims, cfg, weights, model = dims_and_model(config, skew=S > 256)
    tokens = torch.randint(0, dims["vocab"], (S,), generator=torch.Generator().manual_seed(S))
    with torch.no_grad():
        h, _ = transformer.forward(cfg, model.params, tokens[None], attn_impl="xla")
        want = model.logits(h)[0]
    drops = []
    kept = ref.kept

    def counting(expert, m):
        k = kept(expert, m)
        drops.append(int((~k).sum()))
        return k

    ref.kept = counting
    try:
        got = ref.served_logits(dims, harness.leaf_reader(weights), [(tokens, S)])[0]
    finally:
        ref.kept = kept
    # from position 0 on (a one-token "prompt"): every position's logits
    full = ref.served_logits(dims, harness.leaf_reader(weights), [(tokens, 1)])[0]
    assert got.shape == (1, dims["vocab"])
    if config == "stablelm_3b":   # prompt_len only matters to the MoE's capacity rule
        torch.testing.assert_close(full, want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got[0], want[-1], rtol=1e-4, atol=1e-4)
    # the capacity rule ran, and dropped, on every layer past 256 tokens only
    assert len(drops) == (dims["n_layers"] if S > 256 else 0)
    assert S <= 256 or min(drops) > 0


def test_capacity_rule_is_the_programs():
    """Which assignments the capacity rule keeps, against the position
    arithmetic of the program's ``moe_ffn`` (a stable sort by expert)."""
    from repro_torch.models import transformer

    m = {"n_experts": 4, "top_k": 2, "capacity_factor": 1.25, "norm_topk": True}
    T = 300
    expert = torch.randint(0, 4, (T, 2), generator=torch.Generator().manual_seed(1))
    expert[:, 1] = (expert[:, 0] + 1) % 4
    keep = ref.kept(expert, m)
    C = int(torch.ceil(torch.tensor(T * 2 / 4 * 1.25)))
    for e in range(4):
        assert int(keep[expert == e].sum()) == min(C, int((expert == e).sum()))
    # the program's dispatch of the same routing keeps the same assignments
    flat = expert.reshape(-1)
    perm = torch.argsort(flat, stable=True)
    sorted_e = flat[perm]
    idx = torch.arange(T * 2)
    is_start = torch.ones_like(sorted_e, dtype=torch.bool)
    is_start[1:] = sorted_e[1:] != sorted_e[:-1]
    start = torch.cummax(torch.where(is_start, idx, 0), dim=0).values
    pos = (idx - start)[torch.argsort(perm, stable=True)]
    assert torch.equal(keep.reshape(-1), pos < C)
    assert transformer.DENSE_PATH_MAX_TOKENS == 256


def test_train_loss_and_grads_match_the_program():
    dims, cfg, weights, model = dims_and_model("stablelm_3b")
    g = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, dims["vocab"], (48,), generator=g)
    targets = torch.randint(0, dims["vocab"], (48,), generator=g)
    params = {k: w.clone().requires_grad_(True) for k, w in weights.items()}
    loss = ref.train_loss(dims, params, tokens, targets)
    grads = torch.autograd.grad(loss, list(params.values()))
    for p in model.parameters():
        p.requires_grad_(True)
    want = model.train_loss({"tokens": tokens[None], "targets": targets[None]})
    want_g = torch.autograd.grad(want, [dict(model.named_parameters())[k] for k in params])
    torch.testing.assert_close(loss, want, rtol=1e-5, atol=1e-5)
    for k, a, b in zip(params, grads, want_g):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5, msg=k)


def test_adamw_matches_the_program():
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, cosine_schedule

    opt = {"lr": 3e-4, "b1": 0.9, "b2": 0.95, "eps": 1e-8, "weight_decay": 0.1, "grad_clip": 1.0,
           "warmup_steps": 5, "total_steps": 100, "min_lr_ratio": 0.1}
    g = torch.Generator().manual_seed(0)
    p0 = {"a": torch.randn(5, 7, generator=g), "b": torch.randn(3, generator=g)}
    grads = [{k: torch.randn(v.shape, generator=g) * 3 for k, v in p0.items()} for _ in range(3)]
    theirs = {k: v.clone() for k, v in p0.items()}
    state = adamw_init(theirs)
    for gr in grads:
        _, state, _ = adamw_update(AdamWConfig(**opt), theirs, gr, state)
    for step in range(1, 8):
        want = float(cosine_schedule(AdamWConfig(**opt), torch.tensor(step)))
        assert abs(ref_train.learning_rate(opt, step) - want) < 1e-9
    # the reference's optimizer on a loss whose gradient is the given one
    ours = {k: v.clone() for k, v in p0.items()}
    it = iter(grads)

    def fake_loss(run, params, tokens, targets, precision):
        gr = next(it)
        return sum((params[k] * gr[k]).sum() for k in params)

    orig = ref_train.model.train_loss
    ref_train.model.train_loss = fake_loss
    try:
        ref_train.run_steps({}, opt, ours, [{"tokens": None, "targets": None}] * 3)
    finally:
        ref_train.model.train_loss = orig
    for k in p0:
        torch.testing.assert_close(ours[k], theirs[k], rtol=1e-6, atol=1e-7)
