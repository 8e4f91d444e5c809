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

from gpubench import harness, roofline

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


#: a reference module of a family of its own: the dense reference, with the
#: attention of every other layer only (``attention_layers``), as a hybrid's
#: would state fewer attending layers than layers, and further work a token
#: (``token_flops``), as a state-space scan's
THROWAWAY_REFERENCE = '''"""A throwaway family: the dense reference, attending in every other
layer, with 1,000 further FLOPs a token."""

from gpubench.reference import model as dense
from gpubench.reference.model import *  # noqa: F401,F403


def attention_layers(run):
    return dense.attention_layers(run)[::2]


def token_flops(run):
    return 1000
'''


def test_a_new_configuration_is_files_alone(tmp_path):
    """A later change adds a configuration that names a reference module of
    its own, and a cell of it, as new files and new entries of BENCHMARK.json,
    editing no file that is there; the yardstick follows the module's counts."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "gpubench", root / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copytree(ROOT / "src", root / "src", ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / "gpubench").rglob("*") if p.is_file()}
    config = json.loads((ROOT / "gpubench/configs/stablelm_3b.json").read_text())
    config.update(name="throwaway", reference="throwaway")
    (root / "gpubench/configs/throwaway.json").write_text(json.dumps(config))
    (root / "gpubench/reference/throwaway.py").write_text(THROWAWAY_REFERENCE)
    wl = json.loads((ROOT / "gpubench/workloads/stablelm_3b.prefill_heavy.json").read_text())
    wl.update(name="throwaway.prefill", config="throwaway")
    (root / "gpubench/workloads/throwaway.prefill.json").write_text(json.dumps(wl))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="throwaway",
                                 file="gpubench/configs/throwaway.json"))
    bench["workloads"].append({"name": "throwaway.prefill", "config": "throwaway",
                               "traffic": "serve_backlog", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "stablelm_3b.prefill_heavy" in m.get("workloads", []):
            m["workloads"].append("throwaway.prefill")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    line, _ = rehearse(tmp_path, "throwaway.prefill", 0, root=root)
    assert line["correct"] is True and "serve_tokens_per_s" in line["metrics"]

    # the readers of the checkout, on one second of device time and a
    # two-second window: the throwaway cell's inputs follow its module
    code = f"""if True:
        import json, sys
        sys.path[:0] = [{str(root)!r}, {str(root / "src")!r}]
        from gpubench import harness, roofline, trace
        assert harness.ROOT == harness.Path({str(root)!r})

        def read(cell):
            run = harness.open_run(harness.ROOT, cell, 0, True, False)
            run.trace = trace.TraceData(trace.Events.of([("flash_attention_k", 0.0, 1.0)]),
                                        trace.Events.of([(trace.WINDOW, 0.0, 2.0)]))
            run.record.update(served_traced=[(300, 4), (40, 2)], max_len=4096)
            return [harness.reader(m)(run) for m in ("attn_kernel_roofline", "mfu.serve")] + [
                roofline.train_flops(run.dims, 64, 1, harness.reference(run))]

        print(json.dumps([read("stablelm_3b.prefill_heavy"), read("throwaway.prefill")]))
    """
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=root)
    assert out.returncode == 0, out.stderr[-3000:]
    (roof, mfu, train), (roof_half, mfu_half, train_half) = json.loads(out.stdout)
    assert roof_half == pytest.approx(roof / 2, rel=1e-12)
    # 16 of 32 layers' attention left out (32 heads of 80, the pairs by hand),
    # 1,000 FLOPs added for each of the 303 + 41 tokens computed
    pairs = 300 * 301 // 2 + 301 + 302 + 303 + 40 * 41 // 2 + 41
    moved = (4 * 16 * 32 * 80 * pairs - 1000 * 344) / roofline.PEAK_BF16_FLOPS / 2.0 * 100
    assert mfu - mfu_half == pytest.approx(moved, rel=1e-9)
    # training: forward and backward (3 x) of both terms over 64 tokens
    assert train - train_half == 3 * (4 * 16 * 32 * 80 * 64 * 65 // 2 - 1000 * 64)
    assert all(p.read_bytes() == b for p, b in before.items())
