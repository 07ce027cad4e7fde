"""Nothing the benchmark loads is JAX or the JAX package (top-level names
compared whole: ``f9tpu_torch`` is not ``f9tpu``), and the plain reference
loads nothing of the program."""

from __future__ import annotations

import ast
import glob
import json
import os
import subprocess
import sys

import pytest

from bench_h100.harness import FORBIDDEN

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def _imports(path: str) -> list[tuple[str, int]]:
    """(module, relative level) of every import statement in a file."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [(a.name, 0) for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            out.append((node.module or "", node.level))
    return out


def _sources(sub: str = "") -> list[str]:
    return sorted(glob.glob(os.path.join(BENCH, sub, "**", "*.py"), recursive=True))


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, BENCH))
def test_no_source_imports_jax_or_the_jax_package(path):
    bad = [m for m, level in _imports(path) if level == 0 and m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


@pytest.mark.parametrize("path", _sources("reference"), ids=lambda p: os.path.basename(p))
def test_reference_imports_nothing_of_the_program(path):
    for m, level in _imports(path):
        assert level <= 1, f"{m}: the reference reaches outside its folder"
        assert level == 1 or m.split(".")[0] not in ("f9tpu_torch", "bench_h100"), m


def _loaded(code: str) -> list[str]:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_reference_loads_nothing_of_the_program():
    mods = _loaded("import sys, json; sys.path.insert(0, '.')\n"
                   "import bench_h100.reference.pipeline, bench_h100.reference.calibrate\n"
                   "print(json.dumps(sorted(sys.modules)))")
    assert not [m for m in mods if m.split(".")[0] in ("f9tpu_torch", *FORBIDDEN)]


def test_a_run_loads_no_jax():
    mods = _loaded(
        "import sys, json, contextlib, io; sys.path.insert(0, '.'); "
        "sys.path.insert(0, 'bench_h100/tests')\n"
        "import _small\n"
        "with contextlib.redirect_stderr(io.StringIO()):\n"
        "    rc, res = _small.run('reverb48.stems_reverb', trace=1)\n"
        "assert rc == 0 and 'correct' in res\n"
        "print(json.dumps(sorted(sys.modules)))")
    assert "f9tpu_torch.pipeline.graph" in mods
    assert not [m for m in mods if m.split(".")[0] in FORBIDDEN]
