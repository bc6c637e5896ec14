"""Lazy re-exports for the package ``__init__`` modules (PEP 562).

A package's public names are served from the modules that define them on
first access, so importing the package runs none of those modules: the
top level, ``pipeline`` and ``monitoring`` stay free of torch (the
monitor's side process imports ``monitoring.monitor`` and
``pipeline.manifest`` and must never load torch), and ``surface`` stays
importable from the ``ops`` modules that import ``surface.arbitrage``.
"""

from __future__ import annotations

import importlib


def lazy_exports(package: str, table: dict):
    """A module ``__getattr__`` for ``package`` serving each name of
    ``table`` (name -> defining module) from its module."""
    def __getattr__(name: str):
        if name in table:
            return getattr(importlib.import_module(table[name]), name)
        raise AttributeError(f"module {package!r} has no attribute {name!r}")
    return __getattr__
