"""YAML config loading (PyYAML is imported only here, when a file is
read)."""

from __future__ import annotations

from typing import Dict


def load_yaml(path: str) -> Dict:
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)
