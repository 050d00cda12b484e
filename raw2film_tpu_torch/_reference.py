"""Reach the JAX package's numpy-only modules without importing JAX.

The stock data, the film-chain calibration (``raw2film_tpu.film.*``), the
constants (``raw2film_tpu.config``, ``raw2film_tpu.data``), the parameter
schema (``raw2film_tpu.pipeline.params``), the RAW container readers
(``raw2film_tpu.io.dng`` and the readers it dispatches to), the native
decoders and remap (``raw2film_tpu.native``), and the host geometry and
canvas (``raw2film_tpu.pipeline.geometry``, ``canvas``) are plain numpy. The
port reuses them as they are instead of copying them.

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
stock = importlib.import_module(f"{_PKG}.film.stock")
params = importlib.import_module(f"{_PKG}.pipeline.params")
data = importlib.import_module(f"{_PKG}.data")
dng = importlib.import_module(f"{_PKG}.io.dng")
native = importlib.import_module(f"{_PKG}.native")
geometry = importlib.import_module(f"{_PKG}.pipeline.geometry")
canvas = importlib.import_module(f"{_PKG}.pipeline.canvas")


def _exec_private(name: str):
    """Run the module ``name`` from its file into a new module object that is
    not kept in ``sys.modules``."""
    spec = importlib.util.find_spec(name)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def lens_tables(profile_cls) -> tuple[list, list]:
    """(curated, catalog) lens profiles of ``raw2film_tpu.io.lens_db`` and
    ``lens_catalog``, built with ``profile_cls`` in place of the JAX
    package's ``LensProfile``.

    Both modules import ``LensProfile`` from ``raw2film_tpu.io.lens``, which
    imports ``jax.numpy``. So they run from their files with that name
    mapped, for the duration of the call only, to a stand-in module holding
    ``profile_cls``; ``sys.modules`` is restored afterwards."""
    names = (f"{_PKG}.io.lens", f"{_PKG}.io.lens_db")
    saved = {n: sys.modules.get(n) for n in names}
    shim = types.ModuleType(names[0])
    shim.LensProfile = profile_cls
    try:
        sys.modules[names[0]] = shim
        sys.modules.pop(names[1], None)
        db = _exec_private(names[1])
        sys.modules[names[1]] = db
        catalog = _exec_private(f"{_PKG}.io.lens_catalog")
        return list(db.PROFILES), list(catalog.catalog_profiles())
    finally:
        for n, m in saved.items():
            if m is None:
                sys.modules.pop(n, None)
            else:
                sys.modules[n] = m
