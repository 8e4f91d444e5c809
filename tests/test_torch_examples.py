"""The port's examples (``examples/torch_*.py``) against the reference's.

Each port example runs in a process of its own, through a ``runpy`` wrapper
that afterwards asserts that the process loaded neither JAX nor anything of
the reference package.  The two host-code examples are held against the
reference's examples run with the same arguments: ``torch_translate_kernel``
byte for byte; ``torch_serve_daemon`` once each ``<number> ms`` figure and
the store path are masked (latencies are wall-clock times, and the default
store is a fresh temporary directory).  The reference's two training
examples do not run on this tree (their ``Trainer.run()`` on
``make_host_mesh()`` fails), so the port's are held against the reference's
un-meshed step (``torch_quickstart``'s first loss at 1e-5 from the same
carried parameters) and config (``torch_train_100m``'s ``model_100m()``
field for field), and run here on the CPU.  ``torch_serve_batched`` tunes
twice over one artifact store: the first run searches every corpus kernel,
the second is all warm hits with zero passes (the example itself asserts
the warm re-tune and the byte-identical restart).
"""

import dataclasses
import json
import pathlib
import re
import runpy
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLM as JSyntheticLM
from repro.models import Model as JModel
from repro_torch.models.transformer import PORT_ONLY_FIELDS
from repro_torch import convert
from repro_torch.data import SyntheticLM
from repro_torch.runtime import Trainer

ROOT = pathlib.Path(__file__).resolve().parents[1]
ENV = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "2"}

#: the wrapper ``chip_smoke.py`` runs the examples in on the card (its
#: ``main()`` left unrun): the example as ``__main__``, then ``NO-JAX`` on
#: stdout once no JAX or reference module was loaded
RUN = runpy.run_path(str(ROOT / "chip_smoke.py"), run_name="chip_smoke")["EXAMPLE_RUN"]


def _run(example, *args):
    """``examples/<example>.py`` of the port, in the wrapper."""
    return subprocess.run(
        [sys.executable, "-c", RUN, f"examples/{example}.py", *args], cwd=ROOT,
        capture_output=True, text=True, env=ENV, timeout=300,
    )


def _reference(example, *args):
    """``examples/<example>.py`` of the reference, on JAX's CPU backend."""
    return subprocess.run(
        [sys.executable, f"examples/{example}.py", *args], cwd=ROOT, capture_output=True,
        text=True, env={**ENV, "JAX_PLATFORMS": "cpu"}, timeout=300,
    )


def _port_stdout(out):
    """The example's own stdout: the wrapper's closing ``NO-JAX`` line off."""
    assert out.returncode == 0, out.stderr
    assert out.stdout.endswith("\nNO-JAX\n"), out.stdout[-200:]
    return out.stdout[: -len("NO-JAX\n")]


# ---------------------------------------------------------------------------
# torch_translate_kernel: byte for byte
# ---------------------------------------------------------------------------

TRANSLATE_ARGS = {
    "cfd": ["--kernel", "cfd"],
    "conv_overlay": ["--kernel", "conv", "--overlay"],
    "cfd_profile": ["--kernel", "cfd", "--profile"],
    "batch": ["--batch", "cfd,nn,cfd"],
    "cfd_tune": ["--kernel", "cfd", "--tune"],
    "batch_tune_workers": ["--batch", "cfd,nn,cfd", "--tune", "--workers", "2"],
    "nn_tune_profile_trace": ["--kernel", "nn", "--tune", "--profile", "--trace", "TRACE"],
}


@pytest.mark.parametrize("case", sorted(TRANSLATE_ARGS))
def test_translate_kernel_prints_the_references_bytes(tmp_path, case):
    def args(side):
        return [str(tmp_path / f"{side}.json") if a == "TRACE" else a
                for a in TRANSLATE_ARGS[case]]

    ref = _reference("translate_kernel", *args("ref"))
    assert ref.returncode == 0, ref.stderr
    port = _run("torch_translate_kernel", *args("port"))
    assert _port_stdout(port) == ref.stdout
    assert ref.stdout.splitlines()[-1] == "OK"
    if "--trace" in TRANSLATE_ARGS[case]:
        spans = [re.search(r"trace: (\d+) spans", out.stderr) for out in (ref, port)]
        assert all(spans), (ref.stderr, port.stderr)
        assert spans[0].group(1) == spans[1].group(1)
        trace = json.loads((tmp_path / "port.json").read_text())
        assert len(trace["traceEvents"]) == int(spans[1].group(1)) > 0


def test_translate_kernel_refuses_an_unknown_batch_as_the_reference_does():
    ref = _reference("translate_kernel", "--batch", "nosuch")
    port = _run("torch_translate_kernel", "--batch", "nosuch")
    assert ref.returncode == port.returncode == 2
    assert ref.stdout == port.stdout == ""
    # the usage line names each script: compare the error itself
    errors = [out.stderr.strip().splitlines()[-1].split(" error: ", 1)[1] for out in (ref, port)]
    assert errors[0] == errors[1] and "nosuch" in errors[0]


# ---------------------------------------------------------------------------
# torch_serve_daemon: equal once times and the store path are masked
# ---------------------------------------------------------------------------


def _masked(stdout):
    store = re.search(r"== cold serve \(store: (.*)\) ==", stdout).group(1)
    return re.sub(r"\s+[0-9.]+ ms", " <ms>", stdout.replace(store, "<store>"))


@pytest.mark.parametrize("args", [[], ["--chaos"]], ids=["plain", "chaos"])
def test_serve_daemon_prints_the_references_lines(args):
    ref = _reference("serve_daemon", *args)
    assert ref.returncode == 0, ref.stderr
    port = _port_stdout(_run("torch_serve_daemon", *args))
    assert _masked(port) == _masked(ref.stdout)
    assert "pipeline passes run: ZERO (all from disk)" in port
    if args:
        assert "invariant held: 5 fault-free, 1 flagged-degraded, 0 corrupt" in port


def test_serve_daemon_serves_a_kept_store_warm_from_its_cold_start(tmp_path):
    store = str(tmp_path / "store")
    first = _port_stdout(_run("torch_serve_daemon", "--store", store))
    assert "cache hit rate 0.00" in first
    second = _port_stdout(_run("torch_serve_daemon", "--store", store))
    assert f"== cold serve (store: {store}) ==" in second
    assert "store: 4 entries, cache hit rate 1.00" in second


# ---------------------------------------------------------------------------
# torch_quickstart and torch_train_100m: on the CPU, and against the reference
# ---------------------------------------------------------------------------


def test_quickstart_trains_on_a_one_rank_cpu_mesh():
    out = _port_stdout(_run("torch_quickstart", "--device", "cpu")).splitlines()
    assert out[0] == "steps: 60  restarts: 0"
    first, last = map(float, re.fullmatch(r"loss: (\S+) -> (\S+)", out[1]).groups())
    assert last < first
    assert out[2:] == ["OK"]


def test_quickstart_first_step_matches_the_references_unmeshed_step(tmp_path):
    """The example's configs through the un-meshed trainer in float32 on
    the CPU, its initial parameters carried to the reference: the first
    step's loss against ``jax.value_and_grad`` of the reference's
    ``train_loss`` on the reference's own first batch, at 1e-5."""
    configs = runpy.run_path(str(ROOT / "examples" / "torch_quickstart.py"),
                             run_name="port")["configs"](str(tmp_path))
    assert configs["train_cfg"].attn_impl == "xla"
    tcfg = dataclasses.replace(configs["model_cfg"], dtype=torch.float32)
    trainer = Trainer(**{**configs, "model_cfg": tcfg}, device="cpu")
    params, opt = trainer.init_state()
    # copies: the step updates ``params`` in place
    tree = convert.params_to_reference({k: p.detach().clone() for k, p in params.items()})
    batch = SyntheticLM(configs["data_cfg"]).batch(0)
    jbatch = JSyntheticLM(JDataConfig(**dataclasses.asdict(configs["data_cfg"]))).batch(0)
    for k in batch:
        np.testing.assert_array_equal(batch[k], jbatch[k])
    _, metrics = trainer.step(params, opt, {k: torch.from_numpy(v) for k, v in batch.items()})
    jcfg = dataclasses.replace(jconfigs.reduced_config("stablelm_3b"), dtype=jnp.float32)
    jloss, _ = jax.value_and_grad(JModel(jcfg, attn_impl="xla").train_loss)(
        jax.tree.map(jnp.asarray, tree), {k: jnp.asarray(v) for k, v in jbatch.items()})
    np.testing.assert_allclose(float(metrics["loss"]), float(jloss), rtol=1e-5, atol=1e-5)


def test_train_100m_model_equals_the_references_field_for_field():
    """``model_100m()`` of both examples (the reference's module is loaded
    without running its ``main()``) and ``param_count``: 79.97 M."""
    jcfg = runpy.run_path(str(ROOT / "examples" / "train_100m.py"), run_name="ref")["model_100m"]()
    tcfg = runpy.run_path(str(ROOT / "examples" / "torch_train_100m.py"),
                          run_name="port")["model_100m"]()
    names = [f.name for f in dataclasses.fields(jcfg)]
    # the port's own fields (none in the reference) stay at their default
    assert names == [f.name for f in dataclasses.fields(tcfg)
                     if f.name not in PORT_ONLY_FIELDS]
    assert all(getattr(tcfg, f) is None for f in PORT_ONLY_FIELDS)
    for name in names:
        if name == "dtype":
            assert str(tcfg.dtype) == f"torch.{jnp.dtype(jcfg.dtype).name}"
        else:
            assert getattr(tcfg, name) == getattr(jcfg, name), name
    assert tconfigs.param_count(tcfg) == jconfigs.param_count(jcfg) == 79_966_208


def test_train_100m_trains_on_the_cpu_then_resumes_with_no_step_left(tmp_path):
    """Two steps at full width (batch 2 x 32 tokens), then a second run over
    the same ``--ckpt``: it restores the final checkpoint and takes no step."""
    args = ["--device", "cpu", "--steps", "2", "--batch", "2", "--seq", "32",
            "--ckpt", str(tmp_path / "ckpt")]
    out = _port_stdout(_run("torch_train_100m", *args)).splitlines()
    assert out[0] == "model: granite_100m, 80M params"
    assert re.fullmatch(r"done in \d+s \(\d+ tok/s on cpu\)", out[1]), out[1]
    assert [ln.split()[:2] for ln in out[2:4]] == [["step", "0"], ["step", "1"]]
    assert re.fullmatch(r"  final loss \S+ \(started \S+\)", out[4]), out[4]
    assert out[5:] == ["OK"]
    assert [p.name for p in (tmp_path / "ckpt").iterdir()] == ["step_00000002"]
    # bf16 parameters and float32 moments: 0.80 GB
    size = sum(f.stat().st_size for f in (tmp_path / "ckpt").rglob("*") if f.is_file())
    assert 0.79e9 < size < 0.81e9, size
    again = _port_stdout(_run("torch_train_100m", *args)).splitlines()
    assert re.fullmatch(r"done in \d+s \(0 tok/s on cpu\)", again[1]), again[1]
    assert again[2:] == [f"  no step left: resumed at step 2 from {tmp_path / 'ckpt'}", "OK"]


# ---------------------------------------------------------------------------
# torch_serve_batched
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("model,kernels", [("gemma3_1b", 2), ("mamba2_370m", 2)])
def test_tunes_warm_on_the_second_run_then_serves(tmp_path, model, kernels):
    store = str(tmp_path / "store")
    first = _run("torch_serve_batched", "--device", "cpu", "--store", store, "--model", model)
    assert first.returncode == 0, first.stderr
    assert f"tuned {kernels} corpus kernels for {model}" in first.stdout
    assert f"{kernels} searched, 0 cached" in first.stdout
    assert f"re-tune: {kernels}/{kernels} warm hits, byte-identical" in first.stdout
    assert "served 10 requests / 120 tokens on cpu" in first.stdout
    assert first.stdout.split()[-2:] == ["OK", "NO-JAX"]

    second = _run("torch_serve_batched", "--device", "cpu", "--store", store, "--model", model)
    assert second.returncode == 0, second.stderr
    assert f"WARM: all {kernels} from store, zero passes" in second.stdout
    # the same choices, read back from the store
    chose = [ln for ln in first.stdout.splitlines() if "-> chose" in ln]
    assert chose and chose == [ln for ln in second.stdout.splitlines() if "-> chose" in ln]
    assert second.stdout.split()[-2:] == ["OK", "NO-JAX"]


# ---------------------------------------------------------------------------
# the device: the card unless the caller asks for the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("example,args,work", [
    ("torch_serve_batched", ["--store", "STORE"], ("tuned", "served")),
    ("torch_quickstart", [], ("steps:", "loss:")),
    ("torch_train_100m", ["--ckpt", "STORE"], ("model:", "done in")),
])
def test_defaults_to_the_gpu_and_raises_without_one(tmp_path, example, args, work):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: the default runs on it")
    out = _run(example, *[str(tmp_path / "store") if a == "STORE" else a for a in args])
    assert out.returncode != 0
    assert "CUDA device" in out.stderr
    assert not any(w in out.stdout for w in work)
    assert not (tmp_path / "store").exists()
