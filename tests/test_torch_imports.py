"""The PyTorch port stands alone: no module of ``repro_torch``, not
``chip_smoke.py``, not the port's example scripts (``examples/torch_*.py``)
and not the port's timing tools (``tools/*_timing.py``,
``tools/rwkv6_grad_drift.py``) import JAX or anything of the JAX package
``repro``."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT / "src").with_suffix("").parts).removesuffix(".__init__")
    for p in PKG.rglob("*.py"))
FILES = (sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
         + sorted((ROOT / "examples").glob("torch_*.py"))
         + sorted((ROOT / "tools").glob("*_timing.py"))
         + [ROOT / "tools" / "rwkv6_grad_drift.py"])


def _imported_names(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                yield arg.value
            elif isinstance(arg, ast.JoinedStr):
                yield "".join(v.value for v in arg.values if isinstance(v, ast.Constant))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = [n for n in _imported_names(path)
           if n == "jax" or n.startswith("jax.") or n == "repro"
           or n.startswith("repro.") or n.startswith("jaxlib")]
    assert not bad, f"{path.name} imports {bad}"


def test_every_module_imports_with_jax_blocked():
    """Import each port module in a fresh interpreter where ``import jax``
    (and the JAX package ``repro``) fail."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import importlib\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "assert 'jax' not in [k for k, v in sys.modules.items() if v is not None]\n"
        "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=str(ROOT), timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_chip_smoke_imports_no_reference():
    """``chip_smoke.py`` parses, and importing it (without running its main)
    touches neither JAX nor the JAX package."""
    code = (
        "import sys, runpy\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        f"runpy.run_path({str(ROOT / 'chip_smoke.py')!r}, run_name='not_main')\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(ROOT), timeout=120)
    assert res.returncode == 0, res.stderr
