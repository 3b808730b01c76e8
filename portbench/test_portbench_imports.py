"""Nothing the benchmark runs loads JAX or the JAX package, compared by whole
top-level names (the port's name begins with the JAX package's), the reference
loads nothing of the program, and the command refuses to run without a card or
without the program."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BANNED = {"jax", "jaxlib", "flax", "repro"}


def imported(path: Path):
    """Top-level names of every module ``path`` imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_imports_jax_or_the_jax_package():
    for p in HERE.rglob("*.py"):
        assert not imported(p) & BANNED, p


def test_the_reference_imports_nothing_of_the_program():
    for p in list((HERE / "reference").glob("*.py")) + [HERE / "harness" / "check.py"]:
        assert "repro_torch" not in imported(p), p


def test_what_a_run_loads_holds_no_banned_module():
    code = ("import sys, runpy; sys.path[:0] = ['.', 'src']; "
            "runpy.run_path('portbench/run.py', run_name='portbench_run'); "
            "from portbench.harness import cellrun, check, serve, spec, trace, traffic, weights; "
            "import portbench.reference.dense; "
            "import repro_torch.serving, repro_torch.core, repro_torch.models; "
            "from repro_torch.kernels import build; "
            "[spec.metric_reader(p.stem) for p in spec.HERE.joinpath('metrics').glob('*.py')]; "
            "print(cellrun.banned_modules())")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_banned_names_are_compared_whole():
    from portbench.harness import cellrun
    assert cellrun.banned_modules(["repro_torch", "repro_torch.serving", "jaxtyping", "numpy"]) == []
    assert cellrun.banned_modules(["repro_torch", "repro.core", "jax._src"]) == ["jax", "repro"]


def cli(cwd, timeout=120):
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "CUDA_VISIBLE_DEVICES")}
    return subprocess.run([sys.executable, "portbench/run.py", "--workload",
                           "granite-3-8b.longdoc", "--seed", "3", "--seconds", "1", "--trace", "0"],
                          cwd=cwd, env=env, capture_output=True, text=True, timeout=timeout)


def test_the_command_fails_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the command would run")
    out = cli(ROOT)
    assert out.returncode != 0 and out.stdout == ""
    assert "no CUDA device" in out.stderr


def test_the_command_fails_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = cli(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
