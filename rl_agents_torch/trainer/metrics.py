"""Metrics writers.

Port of ``rl_agents_tpu/trainer/metrics.py``: tensorboardX is the primary
channel where it is installed (reference: evaluation.py:325-333);
``NullWriter`` stands in when it is absent, and ``JsonlWriter`` appends one
JSON object a scalar to ``metrics.jsonl`` for machine-readable runs.
"""
from __future__ import annotations

import json
from pathlib import Path


class NullWriter:
    """Metrics sink used when tensorboardX is not installed."""

    def add_scalar(self, *args, **kwargs):
        pass

    def add_histogram(self, *args, **kwargs):
        pass

    def add_image(self, *args, **kwargs):
        pass

    def add_figure(self, *args, **kwargs):
        pass

    def close(self):
        pass


class JsonlWriter(NullWriter):
    """One JSON object per scalar, appended to ``<directory>/metrics.jsonl``."""

    def __init__(self, directory):
        self.path = Path(directory) / "metrics.jsonl"
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._f = self.path.open("a")

    def add_scalar(self, tag, value, step=None):
        self._f.write(json.dumps({"tag": tag, "value": float(value), "step": step}) + "\n")

    def close(self):
        self._f.close()
