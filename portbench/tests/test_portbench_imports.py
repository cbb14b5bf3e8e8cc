"""What the benchmark's modules import, compared by whole top-level names:
the program's package name begins with the JAX package's, so a prefix
match would flag the program."""

import ast
import json
import subprocess
import sys
from pathlib import Path

from portbench import harness

PB = Path(harness.__file__).resolve().parent
JAX_SIDE = {"jax", "jaxlib", "flax", "pinn_for_quantum_wavefunction_surfaces_tpu"}
PORT = "pinn_for_quantum_wavefunction_surfaces_tpu_torch"
# code of the benchmark's folder (the tests are not run by a run)
SOURCES = sorted(p for p in PB.rglob("*.py") if "tests" not in p.parts)


def imported(path: Path) -> set[str]:
    """Top-level names of the absolute imports of a module, and the
    benchmark-relative ones as "portbench.<first part>"."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0:
                names.add(node.module.split(".")[0])
            else:
                rel = path.relative_to(PB).parent.parts
                base = list(rel[:len(rel) - node.level + 1])
                mod = base + (node.module.split(".") if node.module else [])
                targets = [mod] if node.module else \
                    [mod + [a.name] for a in node.names]
                names |= {"portbench." + (t[0] if t else "") for t in targets}
        elif isinstance(node, ast.Call) and getattr(node.func, "attr",
                                                    "") == "import_module":
            arg = node.args[0]
            if isinstance(arg, ast.JoinedStr):
                names.add(ast.unparse(arg))
    return names


def test_no_module_imports_jax_or_the_jax_package():
    for path in SOURCES:
        found = imported(path) & JAX_SIDE
        assert not found, f"{path.relative_to(PB)} imports {found}"


def test_whole_names_tell_the_program_from_the_jax_package():
    assert PORT.startswith("pinn_for_quantum_wavefunction_surfaces_tpu")
    assert PORT.split(".")[0] not in JAX_SIDE


def test_only_program_py_names_the_program():
    for path in SOURCES:
        text = path.read_text()
        if path.name == "program.py":
            assert PORT in text
            continue
        assert PORT not in imported(path), path
        assert f'"{PORT}' not in text, path


def test_the_reference_imports_nothing_of_the_program():
    for path in sorted((PB / "reference").glob("*.py")):
        names = imported(path)
        outside = {n for n in names if n.startswith("portbench.")
                   and n != "portbench.reference"}
        assert not outside, f"{path.name} imports {outside}"
        assert names - {"portbench.reference"} <= {
            "__future__", "contextlib", "math", "numpy", "torch"}, names


PROBE = """
import json, sys, importlib, pkgutil
import portbench
mods = ["portbench." + m.name for m in pkgutil.walk_packages(
    portbench.__path__, "") if not m.name.startswith("tests")]
for m in mods:
    importlib.import_module(m)
from portbench import harness, program
program.module("training.engine"); program.module("training.variational")
print(json.dumps({"top": sorted({m.split(".")[0] for m in sys.modules}),
                  "loaded": mods}))
"""


def test_a_run_loads_no_jax():
    """Every module of the benchmark and the program's trainers, loaded in
    one process: sys.modules holds no JAX name, compared whole."""
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=PB.parent,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert "portbench.run" in res["loaded"]
    assert "portbench.calibrate" in res["loaded"]
    assert PORT in res["top"]
    assert not set(res["top"]) & JAX_SIDE
    assert harness.forbidden_modules() == sorted(
        {m.split(".")[0] for m in sys.modules} & JAX_SIDE)
