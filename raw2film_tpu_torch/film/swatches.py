"""Color-checker swatch rendering for stock previews.

Parity with the reference's ``FilmSpectral.color_checker`` 6x4 RGB swatch
attribute (reference usage: src/raw2film/gui.py:209-259 stock browser)."""

from __future__ import annotations

import numpy as np

from raw2film_tpu_torch.data import REC709_TO_XYZ

# Classic 24-patch checker, sRGB-ish linear values (public nominal colors).
_CHECKER_SRGB = np.array(
    [
        [0.45, 0.32, 0.27], [0.77, 0.58, 0.50], [0.36, 0.48, 0.61],
        [0.34, 0.42, 0.26], [0.51, 0.50, 0.69], [0.39, 0.74, 0.67],
        [0.85, 0.48, 0.18], [0.28, 0.36, 0.65], [0.76, 0.35, 0.39],
        [0.36, 0.23, 0.42], [0.62, 0.74, 0.25], [0.89, 0.63, 0.18],
        [0.16, 0.25, 0.58], [0.28, 0.58, 0.29], [0.69, 0.21, 0.23],
        [0.93, 0.78, 0.13], [0.73, 0.33, 0.58], [0.17, 0.53, 0.63],
        [0.95, 0.95, 0.95], [0.78, 0.78, 0.78], [0.62, 0.62, 0.62],
        [0.46, 0.46, 0.46], [0.31, 0.31, 0.31], [0.19, 0.19, 0.19],
    ]
)


def render_color_checker(stock) -> np.ndarray:
    """Render the 24 patches through the stock's default chain -> (6, 4, 3)
    encoded sRGB floats in [0, 1]."""
    from raw2film_tpu_torch.film import chain

    lin = np.clip(_CHECKER_SRGB, 0, 1) ** 2.2 * 0.9
    xyz = (lin @ REC709_TO_XYZ.T).T.reshape(3, 24, 1)  # (3, 24, 1)

    neg = stock if stock.stage == "camera" else None
    if neg is None:
        # Print stocks: preview through a neutral idealized negative.
        from raw2film_tpu_torch.film.loader import load_film_stocks

        neg = load_film_stocks().get("Kodak Portra 400")
        prt = stock
    else:
        prt = None

    neg_p = chain.build_negative_params(neg, exp_kelvin=neg.native_kelvin)
    prt_p = chain.build_print_params(
        neg, prt, inversion=(prt is None and neg.film_type == "negative"),
        neg_params=neg_p,
    )
    out_p = chain.build_output_params(neg, prt, prt_p, neg_p)
    rgb = chain.render_oracle(xyz, neg_p, prt_p, out_p)  # (3, 24, 1)
    return rgb[:, :, 0].T.reshape(6, 4, 3)
