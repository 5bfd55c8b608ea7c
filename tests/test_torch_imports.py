"""The port stands alone: no module of ``repro_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package, and the package imports on
a machine with no ``triton`` and no ``nvcc``."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch_test_threads  # noqa: F401  (shares the cores among test workers)

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported(path: Path):
    """Absolute module names a file imports (relative imports stay inside
    the package and are skipped)."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported(path) if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path.name} imports {bad}"


def test_package_imports_without_triton_or_nvcc(tmp_path):
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['triton'] = None\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert 'jax' not in sys.modules and 'repro' not in sys.modules\n"
        "print('ok')\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "PATH": str(tmp_path)}
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


@pytest.mark.parametrize("module", ["sharding/__init__.py", "sharding/ctx.py", "sharding/rules.py",
                                    "launch/mesh.py", "launch/specs.py", "launch/train.py",
                                    "training/elastic.py", "launch/dryrun.py",
                                    "launch/roofline.py", "utils/__init__.py", "utils/comms.py",
                                    "kernels/counts.py"])
def test_sharding_and_launch_modules_are_covered(module):
    """The sharding, launch (the dry run and its roofline too), elastic and
    accounting modules are among the files checked above (no ``jax``, no
    ``repro``)."""
    assert ROOT / "src" / "repro_torch" / module in PORT_FILES
