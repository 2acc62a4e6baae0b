"""qadc_tpu_torch imports no JAX anywhere.

An AST scan of every module: this image imports jax at interpreter start,
so sys.modules cannot show whether the port needs it. Tolerance: exact.
"""

import ast
from pathlib import Path

import pytest
import torch

# The suite runs in several worker processes on shared cores; one PyTorch
# thread per worker keeps each from crowding the others.
torch.set_num_threads(1)

PORT = Path(__file__).resolve().parents[1] / "qadc_tpu_torch"
MODULES = sorted(PORT.rglob("*.py"))
FORBIDDEN = ("jax", "qadc_tpu")


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_has_the_mirrored_modules():
    names = {str(p.relative_to(PORT)) for p in MODULES}
    for rel in ("core/packing.py", "core/layout.py", "quantizers/pq.py",
                "quantizers/opq.py", "index/ivf.py", "index/routing.py",
                "index/flat.py", "io/checkpoint.py", "ops/knn.py", "ops/tables.py",
                "ops/quantization.py", "ops/topk.py", "kernels/lut_scan.py", "kernels/scan_ref.py",
                "eval/recall.py", "eval/synth.py", "convert.py", "core/tensors.py",
                "ops/kmeans.py", "index/build.py", "kernels/build.py", "kernels/scan_lab.py",
                "io/vecs.py", "io/native.py", "io/stream.py", "io/quantizer_files.py",
                "eval/metrics.py", "eval/trace.py", "engine.py", "autotune.py", "serve.py",
                "cli/main.py", "dist/__init__.py", "dist/mesh.py", "dist/sharded.py",
                "dist/sharded_ivf.py"):
        assert rel in names, rel


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(PORT)))
def test_module_imports_no_jax(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in FORBIDDEN, f"{path.relative_to(PORT)} imports {name}"


def test_chip_smoke_imports_no_jax():
    path = PORT.parent / "chip_smoke.py"
    for name in _imports(path):
        assert name.split(".")[0] not in FORBIDDEN, name


def test_multiproc_worker_imports_no_jax():
    """The worker of tests/test_torch_multiprocess.py runs the port alone."""
    for name in _imports(PORT.parent / "tests" / "torch_multiproc_worker.py"):
        assert name.split(".")[0] not in FORBIDDEN, name
