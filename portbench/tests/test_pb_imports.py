"""Nothing the benchmark runs imports JAX or the JAX package, and the plain
reference imports nothing of the program. Module names are compared by
their top-level part, whole: the program's name begins with the JAX
package's."""

import ast
import subprocess
import sys

from portbench.harness.spec import PACKAGE, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "dcd_tpu"}


def _imports(path):
    """(top-level name, level) of every import statement of a file."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], 0, a.name
        elif isinstance(node, ast.ImportFrom):
            yield (node.module or "").split(".")[0], node.level, node.module or ""


def test_no_file_imports_jax_or_the_jax_package():
    for path in PACKAGE.rglob("*.py"):
        for top, level, _ in _imports(path):
            assert level > 0 or top not in FORBIDDEN, (path, top)


def test_the_reference_imports_nothing_of_the_program_or_the_harness():
    for path in (PACKAGE / "reference").rglob("*.py"):
        for top, level, full in _imports(path):
            assert level <= 1, (path, full)  # only its own package, relatively
            assert level == 1 or top not in {"dcd_tpu_torch", "portbench"} | FORBIDDEN, (path, full)


def test_a_run_loads_no_forbidden_module(tmp_path):
    code = f"""
import sys, time, pathlib, torch
sys.path.insert(0, {str(ROOT)!r})
from portbench.tests.tiny import make_root
from portbench.harness import spec, report
from portbench.run import forbidden_modules
root = make_root(pathlib.Path({str(tmp_path)!r}), "infer")
cell = spec.load_cell("tiny.infer", False, root)
report.run(cell, 3, 0.2, False, torch.device("cpu"), time.perf_counter)
import portbench.tools.readings
print("FOUND", forbidden_modules())
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "FOUND []"
