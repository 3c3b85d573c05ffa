"""``BENCHMARK.json`` keeps the contract's names and units, every per-layer
metric's cells report the end-to-end metric it moves, and the harness finds
a configuration, a cell and a per-layer metric added as new files and
entries, with no file that is there edited."""
import hashlib
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def manifest(root=ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cells_of(metric: dict, data: dict) -> list:
    return metric.get("workloads", [c["name"] for c in data["workloads"]])


def test_names_and_units_use_the_allowed_characters():
    data = manifest()
    names = [e["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for e in data[key]]
    names += [c["config"] for c in data["workloads"]] + [c["traffic"] for c in data["workloads"]]
    names += [k for c in data["configs"] for k in c["reduced"]]
    for name in names:
        assert NAME.match(name), name
    for metric in data["end_to_end"] + data["per_layer"]:
        assert UNIT.match(metric["unit"]), metric["unit"]
        assert metric["better"] in ("lower", "higher")
    assert len(set(e["name"] for e in data["end_to_end"] + data["per_layer"])) \
        == len(data["end_to_end"]) + len(data["per_layer"])


def test_every_per_layer_metric_moves_an_end_to_end_metric_of_its_cells():
    data = manifest()
    end_to_end = {m["name"]: m for m in data["end_to_end"]}
    for metric in data["per_layer"]:
        moved = end_to_end[metric["moves"]]
        for cell in cells_of(metric, data):
            assert cell in cells_of(moved, data), (metric["name"], cell)
    for cell in data["workloads"]:
        reported = [m["name"] for m in data["end_to_end"] if cell["name"] in cells_of(m, data)]
        assert "setup_s" in reported and len(reported) >= 2, cell["name"]
        assert any(cell["name"] in cells_of(m, data) for m in data["per_layer"]), cell["name"]


def test_every_name_has_its_files():
    data = manifest()
    for config in data["configs"]:
        assert json.loads((ROOT / config["file"]).read_text())["name"] == config["name"]
    for cell in data["workloads"]:
        traffic = json.loads((ROOT / "perfbench" / "traffic" / f"{cell['traffic']}.json")
                             .read_text())
        assert (ROOT / "perfbench" / "loops" / f"{traffic['kind']}.py").is_file()
    for metric in data["per_layer"]:
        assert (ROOT / "perfbench" / "metrics" / f"{metric['name']}.py").is_file()


def test_the_configs_hold_the_corpus_files_they_name():
    for config in manifest()["configs"]:
        held = json.loads((ROOT / config["file"]).read_text())
        env, agent = (json.loads((ROOT / f).read_text()) for f in held["corpus_files"])
        assert held["env"] == env
        assert held["agent"] == agent


def digests(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_and_entries_are_found_and_run(tmp_path):
    copy = tmp_path / "checkout"
    shutil.copytree(ROOT / "perfbench", copy / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", copy / "BENCHMARK.json")
    before = digests(copy / "perfbench")

    config = json.loads((copy / "perfbench" / "configs" / "opd-highway.json").read_text())
    config["name"] = "opd-highway-deeper"
    config["sizes"]["expansions"] = 4
    (copy / "perfbench" / "configs" / "opd-highway-deeper.json").write_text(json.dumps(config))
    (copy / "perfbench" / "traffic" / "batch6.json").write_text(json.dumps(
        {"kind": "batch_plan", "why": "six trees", "trees": 6, "warmup_plans": 1,
         "transition_calls": 2}))
    (copy / "perfbench" / "metrics" / "plans_in_window.batch.py").write_text(
        "def read(record):\n    return float(len(record['plan']['seconds']))\n")
    data = manifest(copy)
    data["configs"].append({"name": "opd-highway-deeper", "source": "https://example.org/x",
                            "file": "perfbench/configs/opd-highway-deeper.json", "reduced": [],
                            "why": "a test"})
    data["workloads"].append({"name": "opd-highway-deeper.batch6", "config": "opd-highway-deeper",
                              "traffic": "batch6", "chips": 1, "why": "a test"})
    data["end_to_end"][[m["name"] for m in data["end_to_end"]].index("plan_rate")][
        "workloads"].append("opd-highway-deeper.batch6")
    data["per_layer"].append({"name": "plans_in_window.batch", "unit": "plans",
                              "better": "higher", "source": "host_clock", "layer": "planner",
                              "moves": "plan_rate", "workloads": ["opd-highway-deeper.batch6"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(data))

    code = f"""
import json, sys
sys.path[:0] = [{str(copy)!r}, {str(ROOT)!r}]
import perfbench
assert perfbench.__file__.startswith({str(copy)!r}), perfbench.__file__
from perfbench.pbcore.rehearse import rehearse
out = [rehearse({str(copy)!r}, "opd-highway-deeper.batch6", 5, seconds=0.05, trace=t)["result"]
       for t in (False, True)]
print(json.dumps(out))
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=copy)
    assert proc.returncode == 0, proc.stderr[-4000:]
    plain, traced = json.loads(proc.stdout.strip().splitlines()[-1])
    assert plain["correct"] and traced["correct"]
    assert set(plain["metrics"]) == {"setup_s", "plan_rate"}
    assert traced["metrics"]["plans_in_window.batch"]["value"] >= 1
    after = digests(copy / "perfbench")
    assert {k: v for k, v in after.items() if k in before} == before


def test_the_loops_and_the_core_know_no_env():
    """Whatever is env-specific sits in ``perfbench/envs/<id>.py``: a
    configuration on another env adds an adapter and edits no loop."""
    import ast

    for path in sorted((ROOT / "perfbench" / "loops").glob("*.py")) \
            + sorted((ROOT / "perfbench" / "pbcore").glob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module:
                assert not node.module.startswith(("perfbench.reference", "perfbench.envs")), \
                    (path, node.module)
            if isinstance(node, (ast.Name, ast.Attribute, ast.alias)):
                name = getattr(node, "id", None) or getattr(node, "attr", None) or node.name
                assert "highway" not in name, (path, name)
