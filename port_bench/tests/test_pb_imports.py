"""No module of the benchmark imports JAX or the JAX package, and the
plain reference imports nothing of the port."""

import ast
import os
import subprocess
import sys

from helpers import ROOT

BENCH = os.path.join(ROOT, "port_bench")
FORBIDDEN = {"jax", "jaxlib", "flax", "dist_renderer_tpu"}


def _modules(folder):
    for dirpath, _, files in os.walk(folder):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _imported(path):
    """Top-level names of every module a file imports, whole."""
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    found = {p: sorted(set(_imported(p)) & FORBIDDEN) for p in _modules(BENCH)}
    assert sum(1 for _ in _modules(BENCH)) > 20
    assert not {p: f for p, f in found.items() if f}


def test_the_top_level_name_is_compared_whole():
    # the port's name begins with the JAX package's: a prefix match would be wrong
    assert "dist_renderer_tpu_torch".split(".")[0] not in FORBIDDEN
    src = "import dist_renderer_tpu.ops\n"
    tree = ast.parse(src)
    assert {a.name.split(".")[0] for a in tree.body[0].names} <= FORBIDDEN


def test_reference_imports_nothing_of_the_port():
    ref = os.path.join(BENCH, "reference")
    names = {n for p in _modules(ref) for n in _imported(p)}
    assert not {n for n in names if n.startswith("dist_renderer_tpu")}
    assert names <= {"__future__", "typing", "numpy", "torch", "math"}, names
    code = ("import sys; sys.path.insert(0, %r); import port_bench.reference.plain, "
            "port_bench.judge; bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'dist_renderer_tpu', 'dist_renderer_tpu_torch')]; "
            "print(bad); sys.exit(1 if bad else 0)") % ROOT
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_a_run_refuses_when_jax_is_loaded(monkeypatch):
    from port_bench import harness

    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    assert harness.forbidden_modules() == ["jaxlib"]
    monkeypatch.delitem(sys.modules, "jaxlib")
    monkeypatch.setitem(sys.modules, "dist_renderer_tpu_torch_like", sys)
    assert harness.forbidden_modules() == []
