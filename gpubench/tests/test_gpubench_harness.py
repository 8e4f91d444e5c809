"""The harness on the CPU: every cell rehearsed end to end at its rehearsal
sizes, the import and path guards, the faults a cell can have turning
``correct`` false, and a throwaway cell and metric taken as files alone."""

import ast
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from gpubench import harness

ROOT = harness.ROOT
BENCH = harness.load_json(ROOT / "BENCHMARK.json")
CELLS = [c["name"] for c in BENCH["workloads"]]
SERVING = [c["name"] for c in BENCH["workloads"] if c["traffic"] != "train"]
TRAINING = [c["name"] for c in BENCH["workloads"] if c["traffic"] == "train"]


def rehearse(tmp_path, cell, trace, root=ROOT, seed=3_000_000_011):
    """``run.py --rehearse`` in a process of its own, with a HOME, an
    XDG_CACHE_HOME and a TMPDIR of its own; its last line, parsed."""
    env = dict(os.environ)
    for k in ("HOME", "XDG_CACHE_HOME", "TMPDIR"):
        env[k] = str(tmp_path / k.lower())
        os.makedirs(env[k], exist_ok=True)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, str(root / "gpubench" / "run.py"), "--workload", cell,
                          "--seed", str(seed), "--seconds", "1", "--trace", str(trace),
                          "--rehearse"], capture_output=True, text=True, env=env, cwd=root,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1]), out.stderr


def listing(path):
    return sorted(os.listdir(path)) if os.path.isdir(path) else []


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_rehearsal_prints_every_metric(tmp_path, cell, trace):
    before = {d: listing(d) for d in ("/tmp", "/dev/shm")}
    line, err = rehearse(tmp_path, cell, trace)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    section = BENCH["per_layer" if trace else "end_to_end"]
    want = {m["name"] for m in section if cell in m.get("workloads", [cell])}
    assert set(line["metrics"]) == want
    for name, m in line["metrics"].items():
        src = next(x["source"] for x in section if x["name"] == name)
        if src in ("device_trace", "host_clock"):   # never a CPU number under a device name
            assert m["value"] is None and m["not_measured"] == "cpu rehearsal"
    # the checks close standard error, each beside its limit
    tail = err.strip().splitlines()[-len(line["checks"]):]
    assert [t.split()[1] for t in tail] == list(line["checks"])
    # nothing written outside the checkout and the given HOME / XDG / TMPDIR
    assert {d: listing(d) for d in before} == before


def test_nothing_imports_jax_or_the_reference_package():
    """By whole top-level name: ``repro_torch`` is the program, ``repro`` is
    not; the reference imports neither nor the program."""
    for path in (ROOT / "gpubench").rglob("*.py"):
        banned = set(harness.BANNED) | ({"repro_torch"} if "reference" in path.parts else set())
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in banned, f"{path}: imports {n}"
    code = ("import sys; sys.path.insert(0, %r); import gpubench.reference.model, "
            "gpubench.reference.train; print(sorted({m.split('.')[0] for m in sys.modules}))"
            % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    loaded = set(eval(out.stdout))
    assert not loaded & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


def test_run_refuses_without_the_program(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark's files
    gives no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "gpubench", tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "gpubench/run.py", "--workload", CELLS[0], "--seed",
                          "1", "--seconds", "1", "--trace", "0", "--rehearse"], cwd=tmp_path,
                         capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()


def in_process(cell, seed=3_000_000_011):
    """``run.main`` in this process (the harness's look for a chip skipped:
    the rehearsal), its last line parsed."""
    sys.path.insert(0, str(ROOT / "gpubench"))
    try:
        import run as entry
    finally:
        sys.path.pop(0)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
        rc = entry.main(["--workload", cell, "--seed", str(seed), "--seconds", "0.5",
                         "--trace", "0", "--rehearse"])
    assert rc == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("cell", SERVING)
def test_serving_faults_turn_correct_false(cell, monkeypatch):
    from repro_torch.models import Model
    from repro_torch.runtime.serving import Server

    assert in_process(cell)["correct"] is True
    # the answer altered where it is produced: every sampled token moved by one
    sample = Server._sample

    def altered(self, logits, rng):
        return (np.array(sample(self, logits, rng)) + 1) % logits.shape[-1]

    with monkeypatch.context() as m:
        m.setattr(Server, "_sample", altered)
        line = in_process(cell)
    assert line["correct"] is False

    # a decode step that returns its state unchanged
    step = Model.decode_step

    def stale(self, tokens, state, check_room=True):
        copy = {k: tuple(t.clone() for t in v) if isinstance(v, tuple) else v.clone()
                for k, v in state.items()}
        h, _ = step(self, tokens, copy, check_room)
        return h, state

    with monkeypatch.context() as m:
        m.setattr(Model, "decode_step", stale)
        assert in_process(cell)["correct"] is False


@pytest.mark.parametrize("cell", TRAINING)
def test_training_faults_turn_correct_false(cell, monkeypatch):
    import repro_torch.runtime.trainer as trainer
    from repro_torch.optim import global_norm

    assert in_process(cell)["correct"] is True

    # a step that returns its state unchanged
    def unchanged(cfg, params, grads, state, grad_norm=None):
        return params, state, {"grad_norm": global_norm(grads), "lr": state["count"] * 0.0}

    with monkeypatch.context() as m:
        m.setattr(trainer, "adamw_update", unchanged)
        line = in_process(cell)
    assert line["correct"] is False and line["checks"]["change_gap"]["value"] > 0.99

    # half of the batch left out, the mean over the rest
    step = trainer.Trainer.step

    def half(self, params, opt_state, batch):
        targets = batch["targets"].clone()
        targets[:, targets.shape[1] // 2:] = -1
        return step(self, params, opt_state, {**batch, "targets": targets})

    with monkeypatch.context() as m:
        m.setattr(trainer.Trainer, "step", half)
        line = in_process(cell)
    assert line["correct"] is False


def test_a_new_cell_and_metric_are_files_alone(tmp_path):
    """A later change adds a cell and a per-layer metric as new files and
    new entries of BENCHMARK.json, editing no file that is there."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "gpubench", root / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copytree(ROOT / "src", root / "src", ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / "gpubench").rglob("*") if p.is_file()}
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    wl = json.loads((ROOT / "gpubench/workloads/stablelm_3b.chat_single.json").read_text())
    wl["name"] = "stablelm_3b.throwaway"
    wl["kind"] = "serve_backlog"
    wl["requests_per_call"] = wl["rehearsal"]["requests_per_call"] = 3
    (root / "gpubench/workloads/stablelm_3b.throwaway.json").write_text(json.dumps(wl))
    (root / "gpubench/metrics/throwaway.requests.py").write_text(
        "def read(run):\n    return float(len(run.record['served']))\n")
    bench["workloads"].append({"name": "stablelm_3b.throwaway", "config": "stablelm_3b",
                               "traffic": "serve_backlog", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "throwaway.requests", "unit": "requests",
                               "better": "higher", "source": "program_counter",
                               "layer": "server", "moves": "serve_tokens_per_s",
                               "workloads": ["stablelm_3b.throwaway"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    line, _ = rehearse(tmp_path, "stablelm_3b.throwaway", 1, root=root)
    assert line["correct"] is True
    assert line["metrics"]["throwaway.requests"]["value"] == line["attempted"] > 0
    assert all(p.read_bytes() == b for p, b in before.items())
