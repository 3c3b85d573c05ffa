"""``BENCHMARK.json`` and the files it names: the cell, its configuration,
its traffic mix and the metrics it reports, each found by its name."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent  # the perfbench directory


class Manifest:
    def __init__(self, root: Path):
        self.root = Path(root)
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        for cell in self.data["workloads"]:
            if cell["name"] == name:
                return cell
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for entry in self.data["configs"]:
            if entry["name"] == name:
                return json.loads((self.root / entry["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads((self.root / "perfbench" / "traffic" / f"{name}.json").read_text())

    @staticmethod
    def _of_cell(metrics: list, cell: str) -> list:
        return [m for m in metrics if cell in m.get("workloads", [cell])]

    def end_to_end(self, cell: str) -> list:
        return self._of_cell(self.data["end_to_end"], cell)

    def per_layer(self, cell: str) -> list:
        return self._of_cell(self.data["per_layer"], cell)

    def module(self, kind: str, name: str):
        """``perfbench/<kind>/<name>.py`` of this checkout, loaded by its path
        (metric names hold dots)."""
        path = self.root / "perfbench" / kind / f"{name}.py"
        if not path.is_file():
            raise FileNotFoundError(f"{path} is missing")
        spec = importlib.util.spec_from_file_location(f"perfbench_{kind}_{name}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module


def peaks(kind: str) -> dict | None:
    """The published peaks of the card named ``kind``, or None."""
    table = json.loads((HERE / "peaks.json").read_text())["cards"]
    return table.get(kind)
