"""Loads a benchmark file by the name that BENCHMARK.json or a data file
gives it, ``<folder>/<name>.py``, so that a later cell, driver, recipe or
metric is a file added and never an edit of one that is there."""

from __future__ import annotations

import importlib.util
from pathlib import Path
from types import ModuleType
from typing import Dict

_LOADED: Dict[Path, ModuleType] = {}


def load(folder: Path, name: str) -> ModuleType:
    """The module ``folder/<name>.py``, loaded once a process."""
    path = (Path(folder) / f"{name}.py").resolve()
    if path in _LOADED:
        return _LOADED[path]
    if not path.is_file():
        raise FileNotFoundError(f"no {path} for {name!r}")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{path.parent.name}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    _LOADED[path] = mod
    return mod
