"""bwa_flow_tpu_torch stands alone: it imports neither JAX nor the JAX
package, and it never moves to the CPU or to a plain version when CUDA
was asked for."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

# small tensors: one intra-op thread per test process (xdist runs six)
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "bwa_flow_tpu_torch"


def _sources():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "bwa_flow_tpu")


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_jax_package_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path}: imports {bad}"


def test_import_leaves_jax_unloaded():
    mods = ["bwa_flow_tpu_torch"] + sorted(
        "bwa_flow_tpu_torch." + ".".join(
            p.relative_to(PKG).with_suffix("").parts)
        for p in PKG.rglob("*.py")
        if p.name not in ("__init__.py", "__main__.py"))
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'bwa_flow_tpu'))\n"
            "print(bad)\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=str(ROOT), env=env, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr[-3000:]


def test_default_device_is_cuda_and_raises_without_it():
    """Entry points run on cuda unless asked for the CPU: without CUDA,
    the default raises instead of moving to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    from bwa_flow_tpu_torch import resolve_device
    from bwa_flow_tpu_torch.index.build import build_index
    from bwa_flow_tpu_torch.pipeline.batch import BatchAligner
    from bwa_flow_tpu_torch.utils.opts import MemOpt
    g = np.frombuffer(b"ACGT", np.uint8)[
        np.random.default_rng(1).integers(0, 4, 2000)].tobytes()
    fm = build_index([("c", "", g)])
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchAligner(MemOpt(), fm)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrappers never run the plain version: CPU tensors raise."""
    from bwa_flow_tpu_torch.ops import extend_cuda
    i32 = torch.int32
    B = 4
    for wrapper in (extend_cuda.extend_core_cuda,
                    extend_cuda.extend_core_cuda16):
        with pytest.raises(ValueError, match="CUDA"):
            wrapper(8, 8, torch.zeros((B, 8), dtype=i32),
                    torch.ones(B, dtype=i32), torch.zeros((B, 8), dtype=i32),
                    torch.ones(B, dtype=i32), torch.ones(B, dtype=i32),
                    torch.zeros((5, 5), dtype=i32), 6, 1, 6, 1, 100, 5, 100)
    assert extend_cuda.n_launches == extend_cuda.n_launches16 == 0


def test_extend_dispatch_follows_the_tensor_device():
    from bwa_flow_tpu_torch.ops import chain2aln_torch, extend_torch
    assert chain2aln_torch._extend_impl(torch.zeros(1)) is \
        extend_torch.extend_core
    assert chain2aln_torch._extend_impl(torch.zeros(1), True) is \
        extend_torch.extend_core16
    for use16 in (False, True):
        with pytest.raises(ValueError):
            chain2aln_torch._extend_impl(torch.empty(1, device="meta"),
                                         use16)
