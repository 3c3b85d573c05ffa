"""Logging configuration.

Port of ``rl_agents_tpu/trainer/logger.py`` (reference: trainer/logger.py:
38-81): an INFO stream handler through ``dictConfig``, or a given dictConfig
(``scripts/configs/{logging,verbose}.json``), and a per-run DEBUG file
handler.
"""
from __future__ import annotations

import logging
import logging.config
from pathlib import Path

_FORMAT = "[%(levelname)s] %(message)s "
_DEBUG_FORMAT = "[%(name)s:%(levelname)s] %(message)s "


def configure(config: dict | None = None, default_level: str = "INFO"):
    if config:
        logging.config.dictConfig(config)
        return
    logging.config.dictConfig({
        "version": 1,
        "disable_existing_loggers": False,
        "formatters": {
            "standard": {"format": _FORMAT},
            "detailed": {"format": _DEBUG_FORMAT},
        },
        "handlers": {
            "default": {
                "level": default_level,
                "formatter": "standard",
                "class": "logging.StreamHandler",
            },
        },
        "loggers": {
            "": {"handlers": ["default"], "level": "DEBUG", "propagate": True},
            "matplotlib": {"level": "WARNING"},
            "PIL": {"level": "WARNING"},
            # torch's own loggers (dynamo, export, distributed) are chatty at DEBUG
            "torch": {"level": "WARNING"},
        },
    })


def add_file_handler(path: Path) -> logging.Handler:
    """Add a DEBUG file handler at ``path`` to the root logger and return it
    (the caller removes and closes it when its run ends)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    handler = logging.FileHandler(path)
    handler.setLevel(logging.DEBUG)
    handler.setFormatter(logging.Formatter(_DEBUG_FORMAT))
    logging.getLogger().addHandler(handler)
    return handler
