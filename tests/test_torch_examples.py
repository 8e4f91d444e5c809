"""``examples/torch_serve_batched.py``: tune the corpus, then serve, on the port.

The example runs in a process of its own, twice over one artifact store:
the first run searches every corpus kernel, the second is all warm hits
with zero passes (the example itself asserts the warm re-tune and the
byte-identical restart).  The process must load neither JAX nor anything
of the reference package.
"""

import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]

RUN = (
    "import runpy, sys\n"
    "sys.argv = ['torch_serve_batched.py'] + sys.argv[1:]\n"
    "runpy.run_path('examples/torch_serve_batched.py', run_name='__main__')\n"
    "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))\n"
    "             or m == 'repro' or m.startswith('repro.'))\n"
    "assert not bad, bad\n"
    "print('NO-JAX')\n"
)


def _run(*args):
    return subprocess.run(
        [sys.executable, "-c", RUN, *args], cwd=ROOT, capture_output=True, text=True,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "OMP_NUM_THREADS": "2"},
        timeout=300,
    )


@pytest.mark.parametrize("model,kernels", [("gemma3_1b", 2), ("mamba2_370m", 2)])
def test_tunes_warm_on_the_second_run_then_serves(tmp_path, model, kernels):
    store = str(tmp_path / "store")
    first = _run("--device", "cpu", "--store", store, "--model", model)
    assert first.returncode == 0, first.stderr
    assert f"tuned {kernels} corpus kernels for {model}" in first.stdout
    assert f"{kernels} searched, 0 cached" in first.stdout
    assert f"re-tune: {kernels}/{kernels} warm hits, byte-identical" in first.stdout
    assert "served 10 requests / 120 tokens on cpu" in first.stdout
    assert first.stdout.split()[-2:] == ["OK", "NO-JAX"]

    second = _run("--device", "cpu", "--store", store, "--model", model)
    assert second.returncode == 0, second.stderr
    assert f"WARM: all {kernels} from store, zero passes" in second.stdout
    # the same choices, read back from the store
    chose = [ln for ln in first.stdout.splitlines() if "-> chose" in ln]
    assert chose and chose == [ln for ln in second.stdout.splitlines() if "-> chose" in ln]
    assert second.stdout.split()[-2:] == ["OK", "NO-JAX"]


def test_defaults_to_the_gpu_and_raises_without_one(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: the default runs on it")
    out = _run("--store", str(tmp_path / "store"))
    assert out.returncode != 0
    assert "CUDA device" in out.stderr
    assert "tuned" not in out.stdout and "served" not in out.stdout
