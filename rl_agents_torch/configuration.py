"""Configuration system: recursive default-config merge + JSON loading.

Port of ``rl_agents_tpu/configuration.py`` (itself a rebuild of the
reference's rl_agents/configuration.py:5-103). Pure Python, kept as a copy so
that this package never imports the JAX package:

* every configurable object exposes a class-level ``default_config()``;
* user configs are merged recursively into the defaults;
* JSON config files may declare ``base_config`` single inheritance
  (reference: rl_agents/agents/common/factory.py:44-56);
* objects serialize back to plain dicts for run metadata.
"""
from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Any, Dict


def rec_update(d: Dict, u: Dict) -> Dict:
    """Recursively update mapping ``d`` with mapping ``u`` (in place)."""
    for k, v in u.items():
        if isinstance(v, dict) and isinstance(d.get(k), dict):
            d[k] = rec_update(d[k], v)
        else:
            d[k] = v
    return d


class Configurable:
    """An object whose behaviour is driven by a dict config.

    The final config is ``default_config()`` recursively overridden by the
    user-provided config; the merged result is stored on ``self.config``.
    """

    def __init__(self, config: Dict | None = None):
        self.config = self.default_config()
        if config:
            rec_update(self.config, config)

    @classmethod
    def default_config(cls) -> Dict:
        return {}


class Serializable(dict):
    """Mixin providing object -> plain-dict conversion for run metadata."""

    def to_dict(self) -> Dict:
        d = {}
        for k, v in self.__dict__.items():
            if isinstance(v, Serializable):
                d[k] = v.to_dict()
            else:
                d[k] = repr(v)
        return d


def serialize(obj: Any) -> Dict:
    """Convert an object to a metadata dict (reference: configuration.py:54-103).

    * objects with a ``config`` dict serialize to that config plus their
      class path under ``__class__``;
    * environments serialize to their spec id + config.
    """
    if hasattr(obj, "config") and isinstance(getattr(obj, "config"), dict):
        d = dict(obj.config)
        d["__class__"] = f"{obj.__class__.__module__}.{obj.__class__.__qualname__}"
        return d
    if hasattr(obj, "spec") and obj.spec is not None:
        d = {"id": obj.spec.id}
        if hasattr(obj, "config"):
            d.update(obj.config)
        return d
    if isinstance(obj, dict):
        return dict(obj)
    return {"repr": repr(obj)}


def load_json_config(path: str | Path) -> Dict:
    """Load a JSON config file, honouring ``base_config`` single inheritance.

    The child file's keys override the base file's keys, recursively; chains
    of ``base_config`` are followed. A relative ``base_config`` resolves
    child-relative first, then against the child's ancestors up to the first
    repository root marker, then against the working directory.
    """
    path = Path(path)
    with path.open() as f:
        config = json.load(f)
    if "base_config" in config:
        base_path = Path(config["base_config"])
        if not base_path.is_absolute():
            ancestors = []
            for anc in path.parents[1:]:
                ancestors.append(anc)
                if any((anc / marker).exists()
                       for marker in ("pyproject.toml", ".git", "setup.py")):
                    break
            candidates = [path.parent / base_path]
            candidates += [anc / base_path for anc in ancestors]
            candidates.append(base_path)
            base_path = next((c for c in candidates if c.is_file()),
                             candidates[0])
            if base_path != candidates[0]:
                logging.getLogger(__name__).info(
                    "base_config %s resolved to non-child-relative candidate %s",
                    config["base_config"], base_path)
        base = load_json_config(base_path)
        del config["base_config"]
        config = rec_update(base, config)
    return config
