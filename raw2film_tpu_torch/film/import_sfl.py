"""Import measured film-stock data from a user's ``spectral_film_lut``.

The reference's look rides the sibling ``spectral_film_lut`` package's
measured datasheet resources (reference: src/raw2film/gui.py:209-259
consumes FilmSpectral attrs; src/raw2film/cpu_processor.py:182 samples
``get_density_curve``). That package is not redistributable here, so this
framework ships datasheet-anchored parametric stocks (film/loader.py) — but
a user who HAS spectral_film_lut installed can import its measured
sensitometry with::

    raw2film-tpu --import-sfl                 # import the installed package
    raw2film-tpu --import-sfl /path/to/pkg    # or a source checkout

mirroring how ``--import-lensfun`` upgrades the heuristic lens catalog with
the user's measured lensfun database.

What is imported per stock (sampled BEHAVIOR, fitted to the analytic device
models — see film/fit.py for why the device path stays analytic):

* the H&D characteristic curve: ``get_density_curve()`` rows -> HDCurve fit
  (residual RMS recorded in the provenance note),
* the MTF table: ``stock.mtf`` -> 4-parameter MTFModel fit,
* RMS granularity and reference metadata (iso, year, manufacturer, stage,
  film_type, medium, resolution, density_measure, alias, comment).

Spectral sensitivities and dye absorptions are NOT observable through the
reconstructed call-site API (SURVEY.md §2.2), so those stay this
framework's parametric defaults; the imported entries say so in their
provenance. Discovery of the stock dictionary is defensive: the sfl API was
reconstructed from call sites, so several plausible entry points are tried
and a clear error names what was found if none match.

Imported stocks persist to ``~/.raw2film_tpu/stocks_imported.json``
(override with R2F_IMPORTED_STOCKS) and are merged into
``film.loader.load_film_stocks()`` at startup, overriding same-name
parametric entries.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from raw2film_tpu_torch.film.fit import fit_hd_curve, fit_mtf
from raw2film_tpu_torch.film.sensitometry import HDCurve
from raw2film_tpu_torch.film.stock import FilmStock, GrainModel, MTFModel

IMPORTED_PATH = os.path.join(
    os.path.expanduser("~"), ".raw2film_tpu", "stocks_imported.json"
)


def imported_stocks_path() -> str:
    return os.environ.get("R2F_IMPORTED_STOCKS", IMPORTED_PATH)


# ------------------------------------------------------------------ export


_META_ATTRS = (
    "manufacturer", "year", "stage", "film_type", "medium", "iso",
    "resolution", "density_measure", "comment",
)


def _looks_like_stock(obj) -> bool:
    return hasattr(obj, "get_density_curve") or hasattr(obj, "density_curve")


def discover_stocks(source: str | None = None) -> dict:
    """Locate spectral_film_lut's name -> FilmSpectral dict.

    ``source``: None = import the installed ``spectral_film_lut``; a path =
    prepend to sys.path first. Tries, in order: film_loader module callables
    whose name mentions load/film, then module-level dicts of stock-like
    objects on the package or its film_loader/film_spectral submodules.
    """
    import importlib
    import sys

    # Scope the sys.path entry to this discovery call: a leaked prefix lets
    # any stray module in the user's checkout (utils.py, tests/, even a
    # vendored numpy/) shadow same-named imports for the rest of the
    # process. Already-imported sfl modules stay in sys.modules, so removal
    # after discovery is safe.
    added = None
    if source and os.path.isdir(source) and source not in sys.path:
        sys.path.insert(0, source)
        added = source
    try:
        return _discover_stocks_inner(importlib)
    finally:
        if added is not None:
            try:
                sys.path.remove(added)
            except ValueError:
                pass


def _discover_stocks_inner(importlib) -> dict:
    try:
        pkg = importlib.import_module("spectral_film_lut")
    except ImportError as e:
        raise ValueError(
            "spectral_film_lut is not importable; install it or pass the "
            f"checkout path ({e})"
        ) from e

    candidates = [pkg]
    for sub in ("film_loader", "film_spectral", "utils"):
        try:
            candidates.append(importlib.import_module(f"spectral_film_lut.{sub}"))
        except ImportError:
            pass

    tried = []
    for mod in candidates:
        for name in dir(mod):
            if name.startswith("_"):
                continue
            obj = getattr(mod, name)
            if isinstance(obj, dict) and obj and all(
                isinstance(k, str) for k in obj
            ) and any(_looks_like_stock(v) for v in obj.values()):
                return {k: v for k, v in obj.items() if _looks_like_stock(v)}
            lname = name.lower()
            if callable(obj) and ("film" in lname or "stock" in lname) and (
                "load" in lname or "database" in lname or lname == "filmstocks"
            ):
                tried.append(f"{mod.__name__}.{name}()")
                try:
                    out = obj()
                except TypeError:
                    continue
                except Exception:
                    continue
                if isinstance(out, dict) and any(
                    _looks_like_stock(v) for v in out.values()
                ):
                    return {k: v for k, v in out.items() if _looks_like_stock(v)}
    raise ValueError(
        "could not locate a film-stock dictionary in spectral_film_lut "
        f"(tried module dicts and {tried or 'no loader callables'}); the "
        "package layout may have changed — please report the version"
    )


def _sample_density_curve(stock):
    """-> (log_e (N,), density (C, N)) from get_density_curve, accepting the
    (4, N) reference layout (row 0 = grid) or an (x, y) tuple."""
    fn = getattr(stock, "get_density_curve", None)
    if fn is None:
        raise ValueError("stock has no get_density_curve")
    out = None
    for args in ((), (0,), (0, None)):
        try:
            out = fn(*args)
            break
        except TypeError:
            continue
    if out is None:
        raise ValueError("get_density_curve signature not recognized")
    if isinstance(out, tuple) and len(out) == 2:
        x, d = np.asarray(out[0], np.float64), np.asarray(out[1], np.float64)
        return x, np.atleast_2d(d)
    arr = np.asarray(out, np.float64)
    if arr.ndim != 2 or arr.shape[0] < 2:
        raise ValueError(f"unexpected density-curve shape {arr.shape}")
    return arr[0], arr[1:]


def _nonempty(v) -> bool:
    """Emptiness without bare truthiness (ndarray truth values raise)."""
    if v is None:
        return False
    if isinstance(v, np.ndarray):
        return v.size > 0
    try:
        return len(v) > 0
    except TypeError:
        return True  # scalar (0.0 RMS is still a recordable measurement)


def import_stock(name: str, stock) -> tuple[dict, dict]:
    """One sfl stock -> (FilmStock-compatible dict, fit report)."""
    x, dens = _sample_density_curve(stock)
    curve, hd_rms = fit_hd_curve(x, dens)

    mtf_model, mtf_rms = None, None
    mtf = getattr(stock, "mtf", None)
    # Never bare truthiness: sfl attrs may be numpy arrays, whose truth
    # value raises (the reference guards the same way, reference:
    # src/raw2film/cpu_processor.py:382 `stock.mtf is not None`).
    if _nonempty(mtf):
        try:
            first = mtf[0] if isinstance(mtf, (list, tuple)) else mtf
            logf, vals = np.asarray(first[0]), np.asarray(first[1])
            mtf_model, mtf_rms = fit_mtf(logf, vals)
        except Exception:
            mtf_model = None

    entry: dict = {"name": name}
    for attr in _META_ATTRS:
        v = getattr(stock, attr, None)
        if v is not None:
            # JSON-safe coercion: sfl attrs can be numpy scalars (iso as
            # np.int64, resolution as np.float64) which json.dump rejects —
            # AFTER the per-stock try/except, killing the whole import.
            if isinstance(v, np.generic):
                v = v.item()
            elif isinstance(v, np.ndarray):
                v = v.tolist()
            if isinstance(v, (str, bool, int, float, list)):
                entry[attr] = v
    alias = getattr(stock, "alias", None)
    if alias:
        entry["alias"] = list(alias) if not isinstance(alias, str) else [alias]
    entry["curve"] = dataclasses.asdict(curve)
    if mtf_model is not None:
        entry["mtf_model"] = dataclasses.asdict(mtf_model)
    rms = getattr(stock, "rms", None)
    if _nonempty(rms):
        # Per-channel RMS arrays collapse to their mean: the grain model
        # carries one scalar granularity (film/stock.py GrainModel.rms).
        entry["grain"] = {"rms": float(np.mean(rms))}
    report = {
        "hd_rms": [float(r) for r in np.atleast_1d(hd_rms)],
        "mtf_rms": mtf_rms,
    }
    entry["provenance"] = (
        "imported from spectral_film_lut (measured sensitometry; analytic "
        f"H&D fit rms={max(report['hd_rms']):.4f}"
        + (f", MTF fit rms={mtf_rms:.4f}" if mtf_rms is not None else "")
        + "); spectral sensitivities/dyes remain parametric defaults"
    )
    return entry, report


def import_sfl_stocks(source: str | None = None, out_path: str | None = None):
    """Import every discoverable sfl stock. Returns (entries, reports) and
    writes the JSON database the loader merges at startup."""
    stocks = discover_stocks(source)
    entries, reports, errors = [], {}, {}
    for name, stock in sorted(stocks.items()):
        try:
            entry, report = import_stock(name, stock)
            entries.append(entry)
            reports[name] = report
        except Exception as e:  # one bad stock must not kill the import
            errors[name] = str(e)
    path = out_path or imported_stocks_path()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    def _np_default(o):
        # Last line of defense: the dump sits OUTSIDE the per-stock loop,
        # so any numpy value that slipped the coercion above must degrade
        # to its python equivalent, not abort the whole import.
        if isinstance(o, np.generic):
            return o.item()
        if isinstance(o, np.ndarray):
            return o.tolist()
        raise TypeError(f"not JSON serializable: {type(o).__name__}")

    with open(path, "w") as f:
        json.dump({"version": 1, "stocks": entries}, f, indent=1, default=_np_default)
    return entries, {"fits": reports, "errors": errors, "path": path}


# ------------------------------------------------------------------ load


def stock_from_dict(entry: dict, base: FilmStock | None = None) -> FilmStock:
    """Deserialize an imported JSON entry into a FilmStock (unknown keys
    ignored). With ``base`` (the same-name parametric stock), only the
    fields the entry actually carries are replaced — the parametric stock's
    tuned spectral sensitivities/dyes and any other unmeasured fields
    survive the overlay instead of resetting to generic dataclass
    defaults."""
    kwargs: dict = {}
    fields = {f.name for f in dataclasses.fields(FilmStock)}
    for k, v in entry.items():
        if k not in fields:
            continue
        if k == "curve":
            kwargs[k] = HDCurve(**{
                kk: tuple(vv) for kk, vv in v.items()
            })
        elif k == "mtf_model":
            kwargs[k] = MTFModel(**v)
        elif k == "grain":
            kwargs[k] = GrainModel(**v)
        elif k == "alias":
            kwargs[k] = tuple(v)
        else:
            kwargs[k] = v
    if base is not None:
        return dataclasses.replace(base, **kwargs)
    return FilmStock(**kwargs)


def load_imported_stocks(
    base: dict[str, FilmStock] | None = None,
) -> dict[str, FilmStock]:
    """The imported-stock overlay for film.loader (empty when none).

    ``base`` maps names to the parametric stocks being overlaid; a
    same-name import keeps the parametric entry's unmeasured fields
    (spectral sensitivities, dye set) and replaces only what was imported.
    """
    path = imported_stocks_path()
    if not os.path.exists(path):
        return {}
    try:
        with open(path) as f:
            doc = json.load(f)
        out = {}
        for entry in doc.get("stocks", []):
            try:
                stock = stock_from_dict(
                    entry, (base or {}).get(entry.get("name"))
                )
                out[stock.name] = stock
            except (TypeError, ValueError):
                continue  # one corrupt entry must not hide the rest
        return out
    except (OSError, json.JSONDecodeError):
        return {}
