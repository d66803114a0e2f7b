"""The port imports neither JAX nor anything of the JAX package."""
import ast
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "src", "repro_torch")


def _port_files():
    # The CUDA kernel tests run on the card, where JAX is not installed.
    out = [os.path.join(ROOT, "chip_smoke.py"),
           os.path.join(ROOT, "tests", "test_torch_cuda_kernels.py"),
           os.path.join(ROOT, "tests", "test_torch_cuda_spgemm.py"),
           os.path.join(ROOT, "tests", "test_torch_cuda_plan.py"),
           os.path.join(ROOT, "tests", "test_torch_cuda_lm.py"),
           os.path.join(ROOT, "tests", "test_torch_cuda_train.py"),
           os.path.join(ROOT, "tests", "test_torch_cuda_lifecycle.py"),
           os.path.join(ROOT, "tests", "test_torch_cuda_tenancy.py"),
           os.path.join(ROOT, "tests", "test_torch_cuda_autotune.py"),
           os.path.join(ROOT, "tests", "test_torch_cuda_sharded.py"),
           os.path.join(ROOT, "tests", "test_torch_cuda_lm_train.py"),
           os.path.join(ROOT, "tests", "test_torch_cuda_proofs.py"),
           os.path.join(ROOT, "tests", "test_torch_cuda_lm_sharded.py"),
           os.path.join(ROOT, "tests", "test_torch_launch_check.py")]
    for base, _, files in os.walk(PORT):
        out += [os.path.join(base, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_repro_import(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                bad.append(node.module)
    assert not bad, f"{path} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys, importlib, pkgutil, repro_torch\n"
            "for m in pkgutil.walk_packages(repro_torch.__path__, "
            "'repro_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
