"""No module of JAX or of the JAX package loads in a run, and the plain
reference imports nothing of the program. Names are compared by their
top-level part, whole: ``rl_agents_torch`` is not ``rl_agents_tpu``."""
import ast
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "rl_agents_tpu"}

REHEARSAL = """
import json, sys
sys.path.insert(0, {root!r})
from perfbench.pbcore.manifest import Manifest
from perfbench.pbcore.rehearse import rehearse
cells = [c["name"] for c in Manifest({root!r}).data["workloads"]]
results = {{c: rehearse({root!r}, c, 2**31 + 11, seconds=0.05, trace=True)["result"]["correct"]
           for c in cells}}
print(json.dumps({{"results": results, "modules": sorted(sys.modules)}}))
"""


def test_a_rehearsal_of_every_cell_loads_no_jax():
    proc = subprocess.run([sys.executable, "-c", REHEARSAL.format(root=str(ROOT))],
                          capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["results"] and all(out["results"].values()), out["results"]
    loaded = {name.split(".")[0] for name in out["modules"]}
    assert "rl_agents_torch" in loaded and "perfbench" in loaded
    assert not loaded & FORBIDDEN, sorted(loaded & FORBIDDEN)


def imported_top_levels(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_the_reference_imports_nothing_of_the_program():
    files = sorted((ROOT / "perfbench" / "reference").glob("*.py"))
    assert files
    for path in files:
        assert imported_top_levels(path) <= {"__future__", "typing", "numpy", "torch",
                                             "perfbench"}, path
    code = ("import sys; sys.path.insert(0, %r); " % str(ROOT)
            + "; ".join(f"import perfbench.reference.{p.stem}" for p in files)
            + "; print(sorted({m.split('.')[0] for m in sys.modules}))")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    loaded = set(ast.literal_eval(proc.stdout.strip().splitlines()[-1]))
    assert "rl_agents_torch" not in loaded and not loaded & FORBIDDEN


def test_the_reference_imports_only_the_reference():
    for path in (ROOT / "perfbench" / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module \
                    and node.module.startswith("perfbench"):
                assert node.module.split(".")[:2] == ["perfbench", "reference"], \
                    (path, node.module)
