"""Reach the JAX package's numpy-only film science without importing JAX.

The stock data, the film-chain calibration (``raw2film_tpu.film.*``), the
constants (``raw2film_tpu.config``, ``raw2film_tpu.data``) and the parameter
schema (``raw2film_tpu.pipeline.params``) are plain numpy. The port reuses
them as they are instead of copying them.

The obstacle is the package ``__init__`` of ``raw2film_tpu``: it imports
``Processor``, which imports ``jax``. Any ``import raw2film_tpu.film.chain``
runs that ``__init__`` first, and fails on a machine without JAX.

So this module:

- uses the real package when ``raw2film_tpu`` is already imported (the
  tests, which run both packages side by side);
- otherwise registers a bare package object named ``raw2film_tpu`` whose
  ``__path__`` is the package directory. Submodule imports then resolve
  against that directory and the package ``__init__`` never runs.

The bare package stays registered for the life of the process: a later
``import raw2film_tpu`` in the same process returns it, without
``Processor`` and the other names the real ``__init__`` exports. A process
that wants the JAX package as well imports it before this module.
"""

from __future__ import annotations

import importlib
import importlib.util
import os
import sys
import types

_PKG = "raw2film_tpu"


def _package_dir() -> str:
    spec = importlib.util.find_spec(_PKG)  # locates; does not execute
    if spec is not None and spec.submodule_search_locations:
        return list(spec.submodule_search_locations)[0]
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.path.join(here, _PKG)
    if not os.path.isdir(path):
        raise ImportError(f"cannot find the {_PKG} package directory")
    return path


def _ensure_package() -> None:
    if _PKG in sys.modules:
        return
    pkg = types.ModuleType(_PKG)
    path = _package_dir()
    pkg.__path__ = [path]
    pkg.__file__ = os.path.join(path, "__init__.py")
    pkg.__package__ = _PKG
    sys.modules[_PKG] = pkg


_ensure_package()

chain = importlib.import_module(f"{_PKG}.film.chain")
loader = importlib.import_module(f"{_PKG}.film.loader")
params = importlib.import_module(f"{_PKG}.pipeline.params")
data = importlib.import_module(f"{_PKG}.data")
