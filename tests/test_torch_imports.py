"""The port stands alone: no module of `f9tpu_torch`, and neither
`chip_smoke.py` nor `examples/demo_torch.py`, imports the JAX package or
jax.

`tests/conftest.py` imports jax into the test process, so the import check
runs in a fresh interpreter; the scan reads every source file's import
statements."""

import ast
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "f9tpu_torch")
SOURCES = sorted(
    [os.path.relpath(os.path.join(d, f), REPO) for d, _, fs in os.walk(PKG)
     for f in fs if f.endswith(".py")]
    + ["chip_smoke.py", os.path.join("examples", "demo_torch.py")])


def _modules() -> list[str]:
    out = []
    for rel in SOURCES:
        if not rel.startswith("f9tpu_torch"):
            continue
        mod = rel[:-3].replace(os.sep, ".")
        out.append(mod[:-len(".__init__")] if mod.endswith(".__init__") else mod)
    return out


def test_importing_the_port_loads_no_jax_package(tmp_path):
    code = f"""
import importlib.util, sys
sys.path.insert(0, {REPO!r})
for m in {_modules()!r}:
    importlib.import_module(m)
spec = importlib.util.spec_from_file_location("chip_smoke", {os.path.join(REPO, 'chip_smoke.py')!r})
importlib.util.module_from_spec(spec).__loader__.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m in ("jax", "f9tpu") or m.startswith(("jax.", "jaxlib", "f9tpu.")))
print("BAD", bad)
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=str(tmp_path), timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "BAD []" in proc.stdout, proc.stdout
    assert len(_modules()) >= 30


@pytest.mark.parametrize("rel", SOURCES)
def test_source_imports_nothing_of_the_jax_package(rel):
    with open(os.path.join(REPO, rel)) as f:
        tree = ast.parse(f.read(), rel)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names = [node.module]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in ("f9tpu", "jax", "jaxlib"), \
                f"{rel}:{node.lineno} imports {name}"


#: the SRC modules from the plain layer up: each imports only those before it
SRC_LAYERS = ("src_plain", "cycle_fold", "src_kernel", "resample")


def test_src_modules_import_one_way_and_never_at_call_time():
    """No module of `f9tpu_torch/ops` imports an SRC module inside a
    function, and an SRC module imports at module level only the layers
    below it: the plain layer no kernel module, each kernel module the plain
    layer, the routed entries both."""
    ops = os.path.join(PKG, "ops")
    for fname in sorted(f for f in os.listdir(ops) if f.endswith(".py")):
        with open(os.path.join(ops, fname)) as f:
            tree = ast.parse(f.read(), fname)
        mod = fname[:-3]
        funcs = [n for n in ast.walk(tree) if isinstance(n, (ast.FunctionDef,
                                                             ast.AsyncFunctionDef))]
        for fn in funcs:
            for node in ast.walk(fn):
                if isinstance(node, ast.ImportFrom) and node.level == 1:
                    assert node.module not in SRC_LAYERS, \
                        f"ops/{fname}:{node.lineno} imports .{node.module} in {fn.name}"
        if mod in SRC_LAYERS:
            below = SRC_LAYERS[:SRC_LAYERS.index(mod)]
            for node in tree.body:
                if isinstance(node, ast.ImportFrom) and node.level == 1 \
                        and node.module in SRC_LAYERS:
                    assert node.module in below, \
                        f"ops/{fname}:{node.lineno} imports .{node.module}, above it"
