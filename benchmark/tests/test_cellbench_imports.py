"""The import rule: nothing a run imports has jax, jaxlib, flax or the JAX
package as its whole top-level name (the port's name begins with the JAX
package's, so the names are compared whole), and the reference imports
nothing of the program."""

import ast
import subprocess
import sys

from benchmark.tests import cellbench_tiny

REPO = cellbench_tiny.REPO
FORBIDDEN = {"jax", "jaxlib", "flax", "ladcast_tpu"}


def imported_top_names(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    files = [p for p in (REPO / "benchmark").rglob("*.py") if "tests" not in p.parts]
    assert files
    for path in files:
        assert not imported_top_names(path) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    for path in (REPO / "benchmark" / "reference").glob("*.py"):
        assert not imported_top_names(path) & (FORBIDDEN | {"ladcast_torch"}), path
    code = ("import sys, benchmark.reference.dit, benchmark.reference.dcae, "
            "benchmark.reference.sampler, benchmark.reference.numerics;"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300, check=True).stdout
    assert "ladcast_torch" not in out and not FORBIDDEN & set(eval(out))


def test_a_run_loads_no_module_of_jax_or_the_jax_package(tmp_path):
    """A whole tiny run, traced, and the control in a fresh process, then
    the harness's own look at ``sys.modules``."""
    code = f"""
import sys
from benchmark import harness, control, run
from benchmark.tests import cellbench_tiny
reg = cellbench_tiny.tiny_root({str(tmp_path)!r})
harness.run_cell(cellbench_tiny.CELL, 5, 0.1, True, reg, "cpu")
control.control_checks(cellbench_tiny.CELL, 5, reg, "cpu")
for m in reg.benchmark()["per_layer"]:
    reg.metric(m["name"])
print("FOUND", harness.forbidden_modules(), "ladcast_torch" in sys.modules)
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=600, check=True).stdout
    assert "FOUND [] True" in out
    assert harness_refuses_a_forbidden_name()


def harness_refuses_a_forbidden_name():
    from benchmark import harness

    sys.modules["ladcast_tpu_probe_ok"] = sys  # a longer name is not the JAX package's
    try:
        clean = "ladcast_tpu" not in harness.forbidden_modules()
        sys.modules["ladcast_tpu.probe"] = sys
        return clean and harness.forbidden_modules() == ["ladcast_tpu"]
    finally:
        sys.modules.pop("ladcast_tpu_probe_ok", None)
        sys.modules.pop("ladcast_tpu.probe", None)
