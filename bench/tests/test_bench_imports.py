"""Nothing the harness, drivers, metrics or reference import is JAX or
the JAX package (top-level names compared whole), and the reference
imports nothing of the port."""

import ast
import subprocess
import sys

from bench.core import env
from bench.core.spec import BENCH, ROOT


def imported_tops(path) -> set:
    tree = ast.parse(path.read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_forbidden_import_in_sources():
    for path in BENCH.rglob("*.py"):
        assert not imported_tops(path) & set(env.FORBIDDEN), path


def test_reference_imports_nothing_of_the_port():
    allowed = {"__future__", "contextlib", "math", "torch", "numpy",
               "bench"}
    for path in (BENCH / "reference").glob("*.py"):
        tops = imported_tops(path)
        assert tops <= allowed, (path, tops - allowed)
        assert "repro_torch" not in tops


def test_names_compared_whole():
    assert env.forbidden_loaded(["repro_torch", "repro_torch.models",
                                 "benchmarks_x", "jaxtyping"]) == []
    assert env.forbidden_loaded(["repro.core", "jax.numpy"]) == \
        ["jax", "repro"]


def test_a_run_loads_no_forbidden_module():
    """Everything the harness imports, every driver, reader and reference,
    in a fresh process: no forbidden top-level name appears, and the
    reference alone loads nothing of the port."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from bench.core import env, spec\n"
        "import bench.reference.dense, bench.reference.compare, "
        "bench.reference.counters\n"
        "assert not [m for m in sys.modules if m.split('.')[0] == "
        "'repro_torch'], 'the reference loaded the port'\n"
        "import bench.run\n"
        "s = spec.load_spec()\n"
        "for w in s['workloads']:\n"
        "    c = spec.cell(w['name'])\n"
        "    spec.driver(c.traffic['driver'])\n"
        "    [spec.reader(m['name']) for m in c.per_layer]\n"
        "    [spec.e2e_module(m['name']) for m in c.end_to_end]\n"
        "import repro_torch.serve, repro_torch.models.pim_compile\n"
        "print(env.forbidden_loaded())\n" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
