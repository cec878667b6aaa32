"""The subpackages' exports, imported at first use.

Each subpackage exports the names its JAX counterpart exports. The modules
of the port import one another across subpackages (the config reads
`columnar/dtypes`, the CSV parser `utils/build_lock`, the validators
`engine/errors`), so a subpackage that imported its exports eagerly would
import the whole engine, in a cycle, whenever one of its small modules is
imported. A module-level ``__getattr__`` (PEP 562) imports a name when it
is first read, and ``from <subpackage> import <name>`` reads it so.
"""

from __future__ import annotations

import importlib
import sys


def lazy_exports(package: str, exports: dict[str, str]):
    """The ``__getattr__`` of ``package``: ``exports`` maps each exported
    name to the submodule it comes from; a name that maps to itself is that
    submodule. The value is kept in the package once read."""

    def __getattr__(name: str):
        if name not in exports:
            raise AttributeError(f"module {package!r} has no attribute {name!r}")
        module = importlib.import_module(f"{package}.{exports[name]}")
        value = module if exports[name] == name else getattr(module, name)
        setattr(sys.modules[package], name, value)
        return value

    return __getattr__
