"""The port stands on its own: it imports torch, never JAX, and nothing of
the JAX package; and it runs on the GPU unless asked for the CPU."""

import pathlib
import pkgutil
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import resolve_device
from repro_torch.configs import reduced_config
from repro_torch.models import Model, transformer
from repro_torch.runtime import ServeConfig, Server

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
MODULES = sorted(
    m.name for m in pkgutil.walk_packages(repro_torch.__path__, prefix="repro_torch.")
)


def test_every_module_is_found():
    for name in ("repro_torch.obs.metrics", "repro_torch.obs.telemetry", "repro_torch.obs.export",
                 "repro_torch.kernels.ref", "repro_torch.kernels._build",
                 "repro_torch.kernels.flash_attention", "repro_torch.kernels.ops",
                 "repro_torch.models.common", "repro_torch.models.attention",
                 "repro_torch.models.transformer", "repro_torch.configs.base",
                 "repro_torch.configs.stablelm_3b", "repro_torch.configs.qwen2_7b",
                 "repro_torch.configs.granite_8b", "repro_torch.configs.gemma3_1b",
                 "repro_torch.kernels.mamba2_ssd", "repro_torch.models.mamba2",
                 "repro_torch.models.hybrid", "repro_torch.configs.mamba2_370m",
                 "repro_torch.configs.zamba2_2_7b", "repro_torch.configs.qwen2_moe_a2_7b",
                 "repro_torch.configs.llama4_scout_17b_a16e", "repro_torch.configs.qwen2_vl_2b",
                 "repro_torch.runtime.serving", "repro_torch.convert", "repro_torch.device",
                 "repro_torch.models.encdec", "repro_torch.configs.whisper_large_v3",
                 "repro_torch.data.pipeline", "repro_torch.optim.adamw",
                 "repro_torch.checkpoint.manager", "repro_torch.runtime.trainer",
                 "repro_torch.sharding", "repro_torch.launch.mesh", "repro_torch.launch.specs",
                 "repro_torch.launch.dryrun", "repro_torch.launch.train",
                 "repro_torch.core.vmem_demotion", "repro_torch.core.tpu_predictor"):
        assert name in MODULES, name


def test_importing_the_port_loads_no_jax_and_nothing_of_the_reference():
    """Every module of the port (``sharding``, ``launch.*`` and ``core.*``
    among them) imports without JAX and the reference, and none starts a
    process group (``launch.mesh`` builds meshes only when called)."""
    code = (
        "import importlib, sys\n"
        f"names = {MODULES!r}\n"
        "for n in ['repro_torch'] + names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "assert 'triton' not in sys.modules\n"
        "import torch.distributed as dist\n"
        "assert not dist.is_initialized(), 'an import started a process group'\n"
        "print('clean', len(names))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["clean", str(len(MODULES))]


@pytest.mark.parametrize(
    "path",
    sorted(str(p.relative_to(ROOT)) for p in (ROOT / "src" / "repro_torch").rglob("*.py"))
    + ["chip_smoke.py", "tools/attention_ab.py", "tools/ssd_ab.py", "tests/torch_mesh_ranks.py"],
)
def test_source_names_neither_jax_nor_the_reference_package(path):
    text = (ROOT / path).read_text()
    pattern = re.compile(r"^\s*(import\s+(jax|repro)\b|from\s+(jax|repro)[\s.])", re.M)
    assert not pattern.search(text), path


def test_cuda_sources_are_package_data():
    csrc = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    assert [p.name for p in sorted(csrc.iterdir())] == ["flash_attention.cu", "mamba2_ssd.cu"]
    for src in csrc.iterdir():
        text = src.read_text()
        assert "torch/extension.h" not in text and 'extern "C"' in text, src.name
        # hand-written: no library of finished kernels inside the kernels
        assert not re.search(r"cublas|cudnn|cutlass|at::|torch::", text, re.I), src.name
    assert 'repro_torch = ["kernels/csrc/*"]' in (ROOT / "pyproject.toml").read_text()


def test_entry_points_default_to_the_gpu_and_never_fall_back():
    """With no CUDA device the defaults raise; only device="cpu" runs here."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: the defaults run on it")
    cfg = reduced_config("stablelm_3b")
    scfg = ServeConfig(batch_slots=2, max_len=16, max_new_tokens=2)
    state = Model(cfg, device="cpu").init(seed=0).state_dict()
    calls = (
        lambda: resolve_device(),
        lambda: resolve_device("cuda:0"),
        lambda: Model(cfg),
        lambda: Model(cfg, device="cuda"),
        lambda: Server(cfg, scfg, state),
        lambda: Server(cfg, scfg, state, device="cuda"),
        lambda: transformer.init_kv_cache(cfg, 1, 8),
    )
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA device"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")
    assert Server(cfg, scfg, state, device="cpu").device.type == "cpu"


def test_chip_smoke_fails_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True,
                         text=True)
    assert out.returncode != 0
    assert out.stdout == "" and "no CUDA device" in out.stderr


def test_chip_smoke_fails_outside_the_repository(tmp_path):
    """Alone in a directory, without the package, it must fail and print no result."""
    (tmp_path / "chip_smoke.py").write_text((ROOT / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True,
                         text=True, env={"PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_a_cuda_tensor_never_reaches_the_plain_version():
    """The wrapper picks the plain version by the tensor's device alone: for a
    tensor that says it is on a CUDA device it takes the kernel path, which
    here (no nvcc, no device) raises — it does not fall back."""
    from repro_torch.kernels import flash_attention as fa

    src = (ROOT / "src" / "repro_torch" / "kernels" / "flash_attention.py").read_text()
    body = src[src.index("def flash_attention("):]
    assert "try:" not in body and "except" not in body
    assert body.count("flash_attention_plain(") == 1
    assert body.index('q.device.type == "cpu"') < body.index("flash_attention_plain(")
    q = torch.zeros(1, 2, 2, 16, device="meta")
    pos = torch.zeros(1, 2, dtype=torch.int32, device="meta")
    before = fa.flash_attention.launches
    with pytest.raises(RuntimeError, match="cuda or cpu"):
        fa.flash_attention(q, q, q, pos, pos)
    assert fa.flash_attention.launches == before
    assert np.isfinite(fa.flash_attention(torch.ones(1, 2, 2, 16), torch.ones(1, 2, 2, 16),
                                          torch.ones(1, 2, 2, 16), torch.zeros(1, 2, dtype=torch.int32),
                                          torch.zeros(1, 2, dtype=torch.int32)).numpy()).all()
