"""The port's copies of the JAX package's numpy modules are the originals.

The port imports nothing of ``raw2film_tpu``; it keeps its own copy, under
the same relative path, of every numpy module it needs. Each copy's source
equals its original after the package-name rewrite (the C++ source of the
native decoders is copied byte for byte), with stated exceptions, each
listed by top-level definition, import or module docstring (``EXCEPT``):
``config.py`` drops ``enable_persistent_jit_cache`` (it imports JAX), the
native loader builds its library into the port's ``_build/`` directory,
``utils/trace.py`` nests a torch profiler range, ``io/thumbnail.py``'s
decode fallback copies its tensor to the host on the caller's device,
``pipeline/batch.py`` drops its unused JAX imports,
``parallel/distributed.py`` joins a torch.distributed group and renders
over its own mesh (its file-list split is the copy), the CLI takes
``--device`` and the port's name, and the viewer builds its Processor on
that device and reports torch from ``/api/about``. Then the copies are held to the originals by what they compute:
the film stocks, the chain parameters, and ``read_raw`` of RAW fixtures.
"""

import ast
import dataclasses
import pathlib
import re

import numpy as np
import pytest

import raw2film_tpu  # noqa: F401  (the real package, imported first)
import raw_fixtures as fx
from raw2film_tpu.film import chain as jchain
from raw2film_tpu.film import loader as jloader
from raw2film_tpu.io import dng as jdng
from raw2film_tpu.io.raf import XTRANS_CANONICAL
from raw2film_tpu_torch.film import chain as tchain
from raw2film_tpu_torch.film import loader as tloader
from raw2film_tpu_torch.io import dng as tdng

ROOT = pathlib.Path(__file__).resolve().parent.parent
RENAME = re.compile(r"(?<![\w./])raw2film_tpu(?!\w)")

COPIES = [
    "config.py", "data.py",
    "film/__init__.py", "film/chain.py", "film/loader.py", "film/stock.py", "film/spectra.py",
    "film/sensitometry.py", "film/fit.py", "film/luts.py", "film/transfer.py",
    "film/swatches.py", "film/grain.py", "film/import_sfl.py",
    "pipeline/params.py", "pipeline/geometry.py", "pipeline/canvas.py",
    "io/dng.py", "io/raf.py", "io/crx.py", "io/cr3.py", "io/crw.py", "io/rw2.py",
    "io/nef.py", "io/pef.py", "io/sr2.py", "io/ljpeg.py", "io/lens_db.py",
    "io/lens_catalog.py", "utils/__init__.py", "utils/workers.py",
    "native/__init__.py", "native/r2f_native.cc",
    "_version.py", "__main__.py", "io/icc.py", "io/export.py", "io/cube.py",
    "io/lensfun_convert.py", "io/thumbnail.py", "pipeline/settings.py", "pipeline/batch.py",
    "parallel/__init__.py", "parallel/distributed.py", "utils/trace.py", "cli.py", "viewer.py",
]
# Top-level definitions, imported modules and "__doc__" (the module
# docstring) a copy leaves out or replaces, per module.
EXCEPT = {
    "config.py": {"enable_persistent_jit_cache"},
    "native/__init__.py": {"_LIB_PATH", "_build"},
    "utils/trace.py": {"__doc__", "torch.profiler", "_ENABLED", "_enabled", "stage_timer"},
    "io/thumbnail.py": {"extract_thumb"},
    "pipeline/batch.py": {"jax", "jax.numpy"},
    "parallel/distributed.py": {
        "__doc__", "numpy", "jax", "jax.numpy", "jax.sharding", "torch", "torch.distributed",
        "init_process", "distributed_batch_render",
    },
    "cli.py": {"__doc__", "build_parser", "main"},
    "viewer.py": {"__doc__", "ViewerState", "_PAGE", "make_handler", "serve"},
}


def _without(src: str, names: set) -> str:
    """``src`` without its top-level definitions, assignments and imports
    of ``names`` (and its docstring for "__doc__"), runs of blank lines
    cut to one and trailing blank space trimmed."""
    lines = src.split("\n")
    drop = set()
    for i, node in enumerate(ast.parse(src).body):
        targets = [getattr(node, "name", None)]
        if isinstance(node, ast.Assign):
            targets = [t.id for t in node.targets if isinstance(t, ast.Name)]
        elif isinstance(node, ast.Import):
            targets = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            targets = [node.module]
        elif i == 0 and isinstance(node, ast.Expr) and isinstance(node.value, ast.Constant):
            targets = ["__doc__"]
        if any(t in names for t in targets):
            drop.update(range(node.lineno - 1, node.end_lineno))
    kept = "\n".join(line for i, line in enumerate(lines) if i not in drop)
    return re.sub(r"\n{3,}", "\n\n", kept).rstrip()


@pytest.mark.parametrize("rel", COPIES)
def test_copy_equals_original(rel):
    original = (ROOT / "raw2film_tpu" / rel).read_text()
    copy = (ROOT / "raw2film_tpu_torch" / rel).read_text()
    want = RENAME.sub("raw2film_tpu_torch", original) if rel.endswith(".py") else original
    if rel == "native/__init__.py":
        want = want.replace("raw2film_tpu_torch/native/libr2f_native.so",
                            "raw2film_tpu_torch/_build/libr2f_native.so")
    names = EXCEPT.get(rel, set())
    if names:
        want, copy = _without(want, names), _without(copy, names)
    assert copy == want


def test_native_builds_into_build_dir():
    from raw2film_tpu_torch import native

    build = ROOT / "raw2film_tpu_torch" / "_build"
    assert pathlib.Path(native._LIB_PATH).parent == build
    assert not (ROOT / "raw2film_tpu_torch" / "native" / "libr2f_native.so").exists()


def _fields(obj):
    if dataclasses.is_dataclass(obj):
        return {f.name: _fields(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return [_fields(v) for v in obj]
    if isinstance(obj, dict):
        return {k: _fields(v) for k, v in obj.items()}
    if isinstance(obj, np.ndarray):
        return ("array", obj.dtype.str, obj.shape, obj.tobytes())
    return obj


def test_film_stocks_equal():
    jstocks, tstocks = jloader.load_film_stocks(), tloader.load_film_stocks()
    assert list(tstocks) == list(jstocks) and len(tstocks) > 10
    for name in jstocks:
        assert _fields(tstocks[name]) == _fields(jstocks[name]), name


# A colour negative on paper, a motion-picture negative on print film, and
# a black-and-white negative inverted without a print stock.
STOCKS = [
    ("Kodak Portra 400", "Fuji Crystal Archive Maxima"),
    ("Kodak Vision3 250D", "Kodak 2383"),
    ("Ilford HP5 Plus 400", None),
]


@pytest.mark.parametrize("neg,prt", STOCKS)
def test_chain_params_equal(neg, prt):
    out = []
    for mod, stocks in ((jchain, jloader.load_film_stocks()), (tchain, tloader.load_film_stocks())):
        n, p = stocks[neg], stocks[prt] if prt else None
        np_ = mod.build_negative_params(n, exp_kelvin=5600.0, exp_comp=0.3, color_masking=0.8)
        pp = mod.build_print_params(n, p, red_light=0.1, inversion=p is None, neg_params=np_)
        op = mod.build_output_params(n, p, pp, np_, sat_adjust=1.1)
        out.append([_fields(x) for x in (np_, pp, op)])
    assert out[0] == out[1]


def _mosaic(h, w, hi=16000, seed=31):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    m = 600 + (hi - 900) * (xx / w) * (0.3 + 0.7 * yy / h) + rng.integers(0, 200, (h, w))
    return np.clip(m, 0, hi).astype(np.uint16)


# name -> writer(path); the containers and codecs of io/dng.py's dispatch.
FIXTURES = {
    "dng": lambda p: jdng.write_dng(p, _mosaic(40, 60), white_level=16383, iso=400),
    "dng-ljpeg-tiled": lambda p: fx.write_dng_tiled(p, _mosaic(64, 96)),
    "nef": lambda p: fx.write_nef_compressed(p, _mosaic(32, 48, hi=16383)),
    "rw2": lambda p: fx.write_rw2(p, fx.rw2_walk_mosaic(20, 14 * 10)),
    "raf-xtrans": lambda p: fx.write_raf(p, _mosaic(66, 96, hi=16383), xtrans=XTRANS_CANONICAL,
                                         compressed=True, block_size=96),
    "arw": lambda p: fx.write_arw2(p, fx.arw2_walk_mosaic(20, 64)),
    "orf": lambda p: fx.write_orf_compressed(p, _mosaic(32, 48, hi=4095)),
    "pef": lambda p: fx.write_pef(p, _mosaic(32, 48, hi=16383)),
    "crw": lambda p: fx.write_crw_raw(p, _mosaic(32, 48, hi=1023)),
    "cr2": lambda p: fx.write_cr2(p, _mosaic(32, 48, hi=16383)),
    "cr3": lambda p: fx.write_cr3_raw(p, _mosaic(64, 96, hi=16383), levels=2),
}
SUFFIX = {"dng-ljpeg-tiled": "dng", "raf-xtrans": "raf", "arw": "arw"}


@pytest.mark.parametrize("name", list(FIXTURES))
def test_read_raw_equal(name, tmp_path):
    path = str(tmp_path / f"f.{SUFFIX.get(name, name)}")
    FIXTURES[name](path)
    want, got = jdng.read_raw(path), tdng.read_raw(path)
    assert type(got) is tdng.RawImage
    for f in dataclasses.fields(want):
        a, b = getattr(want, f.name), getattr(got, f.name)
        if isinstance(a, np.ndarray):
            assert b.dtype == a.dtype and b.shape == a.shape
            np.testing.assert_array_equal(b, a)
        else:
            assert b == a, f.name
