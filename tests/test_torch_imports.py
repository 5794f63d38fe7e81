"""repro_torch stands alone: no module of it (nor chip_smoke.py) imports
jax or the JAX package, importing all of it leaves jax unloaded, and its
entry points refuse to drop to the CPU when CUDA is asked for but absent."""
import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"


def _port_files():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _all_port_modules():
    import repro_torch
    return ["repro_torch"] + [
        m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch.")]


def test_no_jax_or_repro_imports_in_the_port():
    files = _port_files()
    assert len(files) > 20 and (REPO / "chip_smoke.py").exists()
    bad = [(str(f.relative_to(REPO)), m) for f in files
           for m in _imported_modules(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"port imports jax / the JAX package: {bad}"


def test_importing_every_port_module_leaves_jax_unloaded():
    mods = _all_port_modules()
    assert {"repro_torch.launch.serve", "repro_torch.launch.train",
            "repro_torch.launch.steps", "repro_torch.optim.adam",
            "repro_torch.kernels.cross_entropy.cross_entropy",
            "repro_torch.data.loader", "repro_torch.launch.mesh",
            "repro_torch.core.comm", "repro_torch.core.buckets",
            "repro_torch.core.compression",
            "repro_torch.kernels.quantize.ops",
            "repro_torch.kernels.quantize.quantize",
            "repro_torch.kernels.quantize.ref",
            "repro_torch.configs.deepseek_v2_236b",
            "repro_torch.kernels.mla_decode.ops",
            "repro_torch.kernels.mla_decode.mla_decode",
            "repro_torch.kernels.mla_decode.ref",
            "repro_torch.configs.zamba2_2_7b",
            "repro_torch.kernels.ssd_scan.ops",
            "repro_torch.kernels.ssd_scan.ssd_scan",
            "repro_torch.kernels.ssd_scan.ref",
            "repro_torch.models.ssm",
            "repro_torch.configs.xlstm_125m",
            "repro_torch.kernels.mlstm_scan.ops",
            "repro_torch.kernels.mlstm_scan.mlstm_scan",
            "repro_torch.kernels.mlstm_scan.ref",
            "repro_torch.models.xlstm"} <= set(mods)
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n"
            "print(len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_serve_without_cpu_device_raises_when_cuda_is_absent():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks its absence")
    from repro_torch.launch import serve
    from repro_torch.models.model import build_model
    from repro_torch.configs.base import smoke_config
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--smoke", "--requests", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(smoke_config("tinyllama-1.1b"))
    with pytest.raises(SystemExit, match="one device"):
        serve.main(["--smoke", "--device", "cpu", "--devices", "2,1"])
