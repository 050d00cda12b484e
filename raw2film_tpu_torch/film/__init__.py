"""Film science core (host NumPy).

Replaces the reference's external ``spectral_film_lut`` package (reference
call-sites: src/raw2film/cpu_processor.py:7-12, src/raw2film/effects.py:15-17).
Owns the spectral model, film stock database, sensitometry (H&D curves),
LUT construction, and grain science. All arrays here are small (curves,
matrices, LUTs) — per-pixel work lives in :mod:`raw2film_tpu_torch.ops`.
"""

from raw2film_tpu_torch.film.stock import FilmStock
from raw2film_tpu_torch.film.loader import load_film_stocks

__all__ = ["FilmStock", "load_film_stocks"]
