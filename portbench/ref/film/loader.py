"""The film stock database.

Role of the reference's ``spectral_film_lut.film_loader`` (reference:
src/raw2film/__main__.py:27-31 loads a dict[str, FilmSpectral]). Stocks are
original parametric definitions GROUNDED in published datasheet figures
where those exist: every entry carries a ``provenance`` note (PROVENANCE
table below) naming which numbers are adopted verbatim from a published
sheet (diffuse RMS granularity, MTF-50 chart reads, CI/gamma aims, D-max)
and which are class estimates positioned against that published scale.
Spectral sensitivity/dye curves remain parametric constructions (the sheets
publish only low-resolution charts), so *look* parity to the real stocks is
approximate; the sensitometric magnitudes are datasheet-anchored and tested
(tests/test_film_science.py::TestDatasheetAnchors).
"""

from __future__ import annotations

from functools import lru_cache

from portbench.ref.film.sensitometry import HDCurve
from portbench.ref.film.stock import (
    DyeSet,
    FilmStock,
    GrainModel,
    MTFModel,
    Sensitivities,
)


def _neg_curve(gamma, dmin=(0.20, 0.62, 0.90), speed=0.0, latitude=3.1, toe=0.35, sh=0.5):
    """Color-negative H&D curve. ``speed`` shifts the whole curve in stops of
    extra sensitivity (curve moves left); latitude = straight-line span."""
    g = gamma if isinstance(gamma, (tuple, list)) else (gamma, gamma * 1.045, gamma * 1.09)
    x_toe = -2.45 - speed * 0.301
    return HDCurve(
        d_min=tuple(dmin),
        gamma=tuple(g),
        x_toe=(x_toe, x_toe, x_toe),
        x_shoulder=(x_toe + latitude,) * 3,
        w_toe=(toe,) * 3,
        w_shoulder=(sh,) * 3,
    )


def _bw_curve(gamma=0.65, dmin=0.12, speed=0.0, latitude=3.3):
    x_toe = -2.4 - speed * 0.301
    return HDCurve(
        d_min=(dmin,),
        gamma=(gamma,),
        x_toe=(x_toe,),
        x_shoulder=(x_toe + latitude,),
        w_toe=(0.4,),
        w_shoulder=(0.55,),
    )


def _slide_curve(gamma=-1.7, dmax=3.5, dmin=0.12, latitude=2.0):
    """Reversal: density falls with exposure (gamma < 0); d_min field holds
    the high (unexposed) density end. Curve is placed so mid-grey
    (logE = -0.745) develops to density ~1.0 — the standard slide aim."""
    x_toe = -0.745 - (dmax - 1.0) / abs(gamma)
    return HDCurve(
        d_min=(dmax, dmax, dmax),
        gamma=(gamma, gamma * 1.02, gamma * 1.05),
        x_toe=(x_toe,) * 3,
        x_shoulder=(x_toe + (dmax - dmin) / abs(gamma),) * 3,
        w_toe=(0.28,) * 3,
        w_shoulder=(0.22,) * 3,
    )


def _bw_paper_curve(gamma=2.0, dmin=0.06, dmax=2.15):
    """Single-layer silver-gelatin paper curve (grade ~ gamma)."""
    lat = (dmax - dmin) / gamma
    return HDCurve(
        d_min=(dmin,),
        gamma=(gamma,),
        x_toe=(-1.45 - lat / 2,),
        x_shoulder=(-1.45 + lat / 2,),
        w_toe=(0.20,),
        w_shoulder=(0.16,),
    )


def _paper_curve(gamma=2.8, dmin=0.07, dmax=2.35):
    lat = (dmax - dmin) / gamma
    return HDCurve(
        d_min=(dmin, dmin * 1.1, dmin * 1.25),
        gamma=(gamma, gamma * 1.02, gamma * 1.05),
        x_toe=(-1.45 - lat / 2,) * 3,
        x_shoulder=(-1.45 + lat / 2,) * 3,
        w_toe=(0.22,) * 3,
        w_shoulder=(0.18,) * 3,
    )


def _stocks() -> list[FilmStock]:
    s: list[FilmStock] = []

    # ----------------------------------------------------- color negatives
    s.append(
        FilmStock(
            name="Kodak Portra 400",
            manufacturer="Kodak",
            year=2010,
            iso=400,
            resolution=115,
            curve=_neg_curve(0.60, speed=0.0, latitude=3.4, toe=0.42, sh=0.62),
            sens=Sensitivities(peaks=(642.0, 549.0, 467.0), widths=(37.0, 36.0, 33.0)),
            grain=GrainModel(rms=4.3),
            mtf_model=MTFModel(f50=52.0, adj=0.28),
            comment="Soft, wide-latitude portrait negative.",
        )
    )
    s.append(
        FilmStock(
            name="Kodak Portra 160",
            manufacturer="Kodak",
            year=2011,
            iso=160,
            resolution=125,
            curve=_neg_curve(0.58, latitude=3.3, toe=0.40, sh=0.60),
            sens=Sensitivities(peaks=(642.0, 549.0, 467.0), widths=(36.0, 35.0, 32.0)),
            grain=GrainModel(rms=3.2),
            mtf_model=MTFModel(f50=60.0, adj=0.26),
        )
    )
    s.append(
        FilmStock(
            name="Kodak Portra 800",
            manufacturer="Kodak",
            year=1998,
            iso=800,
            resolution=100,
            curve=_neg_curve(0.61, latitude=3.2, toe=0.45, sh=0.62),
            grain=GrainModel(rms=5.9),
            mtf_model=MTFModel(f50=44.0, adj=0.30),
        )
    )
    s.append(
        FilmStock(
            name="Kodak Ektar 100",
            manufacturer="Kodak",
            year=2008,
            iso=100,
            resolution=160,
            curve=_neg_curve(0.72, latitude=2.8, toe=0.30, sh=0.45),
            sens=Sensitivities(peaks=(648.0, 546.0, 462.0), widths=(33.0, 33.0, 30.0)),
            dyes=DyeSet(unwanted=(0.08, 0.13, 0.03)),
            grain=GrainModel(rms=2.6),
            mtf_model=MTFModel(f50=80.0, adj=0.33),
            comment="Saturated, ultra-fine-grain landscape negative.",
        )
    )
    s.append(
        FilmStock(
            name="Kodak Gold 200",
            manufacturer="Kodak",
            year=1997,
            iso=200,
            resolution=100,
            curve=_neg_curve(0.66, dmin=(0.22, 0.66, 0.98), latitude=3.0),
            grain=GrainModel(rms=4.4),
            mtf_model=MTFModel(f50=50.0, adj=0.27),
        )
    )
    s.append(
        FilmStock(
            name="Fuji Pro 400H",
            manufacturer="Fujifilm",
            year=2004,
            iso=400,
            resolution=110,
            # Pastel, cool-leaning: soft per-channel contrast spread (greens
            # slightly favored), broader sensitivities, softer dye purity.
            curve=HDCurve(
                d_min=(0.18, 0.60, 0.92),
                gamma=(0.565, 0.615, 0.635),
                x_toe=(-2.45, -2.45, -2.45),
                x_shoulder=(0.95, 0.95, 0.95),
                w_toe=(0.5, 0.45, 0.45),
                w_shoulder=(0.62, 0.62, 0.62),
            ),
            sens=Sensitivities(peaks=(634.0, 554.0, 472.0), widths=(42.0, 41.0, 37.0)),
            dyes=DyeSet(unwanted=(0.16, 0.22, 0.06)),
            color_masking_strength=0.16,
            grain=GrainModel(rms=4.0),
            mtf_model=MTFModel(f50=50.0, adj=0.26),
            comment="Cool-leaning, pastel 4th-layer negative.",
        )
    )
    s.append(
        FilmStock(
            name="Fuji Superia X-Tra 400",
            manufacturer="Fujifilm",
            year=1998,
            iso=400,
            resolution=105,
            curve=_neg_curve(0.65, dmin=(0.21, 0.64, 0.96), latitude=3.1),
            sens=Sensitivities(peaks=(637.0, 553.0, 469.0), widths=(37.0, 37.0, 33.0)),
            grain=GrainModel(rms=5.2),
            mtf_model=MTFModel(f50=48.0, adj=0.28),
        )
    )
    s.append(
        FilmStock(
            name="Kodak Vision3 50D",
            manufacturer="Kodak",
            year=2012,
            iso=50,
            resolution=175,
            curve=_neg_curve(0.55, dmin=(0.18, 0.55, 0.85), latitude=3.8, toe=0.40, sh=0.70),
            grain=GrainModel(rms=2.4),
            mtf_model=MTFModel(f50=85.0, adj=0.32),
            comment="Motion-picture daylight negative.",
        )
    )
    s.append(
        FilmStock(
            name="Kodak Vision3 250D",
            manufacturer="Kodak",
            year=2009,
            iso=250,
            resolution=140,
            curve=_neg_curve(0.55, dmin=(0.19, 0.57, 0.87), latitude=3.8, toe=0.42, sh=0.70),
            grain=GrainModel(rms=3.4),
            mtf_model=MTFModel(f50=65.0, adj=0.30),
        )
    )
    s.append(
        FilmStock(
            name="Kodak Vision3 500T",
            manufacturer="Kodak",
            year=2007,
            iso=500,
            native_kelvin=3200.0,
            resolution=120,
            curve=_neg_curve(0.56, dmin=(0.20, 0.58, 0.88), latitude=3.7, toe=0.45, sh=0.70),
            sens=Sensitivities(peaks=(645.0, 550.0, 463.0), widths=(38.0, 36.0, 33.0)),
            grain=GrainModel(rms=4.6),
            mtf_model=MTFModel(f50=55.0, adj=0.30),
            comment="Tungsten-balanced motion-picture negative.",
        )
    )
    s.append(
        FilmStock(
            name="CineStill 800T",
            manufacturer="CineStill",
            year=2012,
            iso=800,
            native_kelvin=3200.0,
            resolution=110,
            curve=_neg_curve(0.56, dmin=(0.16, 0.54, 0.84), latitude=3.6, toe=0.45, sh=0.68),
            sens=Sensitivities(peaks=(645.0, 550.0, 463.0), widths=(38.0, 36.0, 33.0)),
            grain=GrainModel(rms=5.4),
            mtf_model=MTFModel(f50=52.0, adj=0.30),
            comment="Remjet-removed 500T: prone to strong red halation.",
        )
    )

    s.append(
        FilmStock(
            name="Fuji C200",
            manufacturer="Fujifilm",
            year=2001,
            iso=200,
            resolution=100,
            curve=_neg_curve(0.63, dmin=(0.20, 0.63, 0.94), latitude=3.0),
            sens=Sensitivities(peaks=(636.0, 555.0, 470.0), widths=(38.0, 38.0, 34.0)),
            grain=GrainModel(rms=5.0),
            mtf_model=MTFModel(f50=47.0, adj=0.26),
            comment="Budget daily-driver with a green-leaning palette.",
        )
    )
    s.append(
        FilmStock(
            name="Agfa Vista 200",
            manufacturer="Agfa",
            year=1999,
            iso=200,
            resolution=95,
            curve=_neg_curve(0.64, dmin=(0.23, 0.68, 1.00), latitude=2.9),
            sens=Sensitivities(peaks=(645.0, 550.0, 462.0), widths=(40.0, 39.0, 35.0)),
            grain=GrainModel(rms=5.2),
            mtf_model=MTFModel(f50=46.0, adj=0.25),
            comment="Warm consumer negative: red-forward, sunny-day palette.",
        )
    )
    s.append(
        FilmStock(
            name="Kodak Ultramax 400",
            manufacturer="Kodak",
            year=1997,
            iso=400,
            resolution=100,
            curve=_neg_curve(0.63, latitude=3.0, toe=0.40, sh=0.58),
            sens=Sensitivities(peaks=(646.0, 550.0, 463.0), widths=(41.0, 40.0, 36.0)),
            grain=GrainModel(rms=5.6),
            mtf_model=MTFModel(f50=46.0, adj=0.26),
            comment="Consumer 400 negative: warm, forgiving, visibly grainy.",
        )
    )
    s.append(
        FilmStock(
            name="Kodak ColorPlus 200",
            manufacturer="Kodak",
            year=2007,
            iso=200,
            resolution=100,
            curve=_neg_curve(0.63, dmin=(0.22, 0.66, 0.98), latitude=2.9, toe=0.38),
            sens=Sensitivities(peaks=(644.0, 551.0, 464.0), widths=(43.0, 41.0, 37.0)),
            grain=GrainModel(rms=5.0),
            mtf_model=MTFModel(f50=44.0, adj=0.24),
            comment="Budget Kodacolor-lineage emulsion: muted, vintage palette.",
        )
    )
    s.append(
        FilmStock(
            name="Kodak Aerocolor IV 125",
            manufacturer="Kodak",
            year=1998,
            iso=125,
            resolution=125,
            # Unmasked aerial negative (SO-250 class): near-neutral base
            # instead of the C-41 orange mask, no masking couplers, higher
            # native gamma than portrait films.
            color_masking_strength=0.0,
            curve=_neg_curve(
                0.74, dmin=(0.14, 0.16, 0.19), latitude=2.9, toe=0.32, sh=0.5
            ),
            sens=Sensitivities(peaks=(648.0, 548.0, 462.0), widths=(38.0, 37.0, 34.0)),
            grain=GrainModel(rms=3.9),
            mtf_model=MTFModel(f50=72.0, adj=0.30),
            alias=("Santacolor 100", "Flic Film Elektra 100"),
            comment="Unmasked aerial color negative (the 'Santacolor' respools).",
        )
    )
    s.append(
        FilmStock(
            name="Fuji Natura 1600",
            manufacturer="Fujifilm",
            year=2004,
            iso=1600,
            resolution=85,
            curve=_neg_curve(0.62, latitude=3.1, toe=0.46, sh=0.60),
            sens=Sensitivities(peaks=(648.0, 545.0, 460.0), widths=(43.0, 41.0, 37.0)),
            grain=GrainModel(rms=8.2),
            mtf_model=MTFModel(f50=36.0, adj=0.28),
            comment="Highest-speed consumer color negative (Natura P mode).",
        )
    )
    s.append(
        FilmStock(
            name="Kodak Portra 160 NC",
            manufacturer="Kodak",
            year=1998,
            iso=160,
            resolution=120,
            alias=("Portra NC",),
            curve=_neg_curve(0.54, latitude=3.5, toe=0.48, sh=0.66),
            sens=Sensitivities(peaks=(642.0, 549.0, 467.0), widths=(38.0, 37.0, 34.0)),
            dyes=DyeSet(unwanted=(0.14, 0.20, 0.05)),
            grain=GrainModel(rms=3.4),
            mtf_model=MTFModel(f50=55.0, adj=0.24),
            comment="Neutral-contrast wedding classic (pre-2010 Portra).",
        )
    )
    s.append(
        FilmStock(
            name="Kodak Portra 160 VC",
            manufacturer="Kodak",
            year=1998,
            iso=160,
            resolution=120,
            alias=("Portra VC",),
            curve=_neg_curve(0.66, latitude=3.0, toe=0.36, sh=0.5),
            sens=Sensitivities(peaks=(644.0, 548.0, 465.0), widths=(35.0, 34.0, 31.0)),
            dyes=DyeSet(unwanted=(0.09, 0.14, 0.03)),
            grain=GrainModel(rms=3.6),
            mtf_model=MTFModel(f50=55.0, adj=0.28),
            comment="Vivid-contrast sibling of the NC.",
        )
    )

    s.append(
        FilmStock(
            name="Kodak Vision3 200T",
            manufacturer="Kodak",
            year=2010,
            iso=200,
            native_kelvin=3200.0,
            resolution=150,
            curve=_neg_curve(0.55, dmin=(0.19, 0.56, 0.86), latitude=3.8, toe=0.43, sh=0.70),
            sens=Sensitivities(peaks=(645.0, 550.0, 463.0), widths=(38.0, 36.0, 33.0)),
            grain=GrainModel(rms=3.0),
            mtf_model=MTFModel(f50=70.0, adj=0.30),
            comment="Tungsten-balanced mid-speed motion-picture negative.",
        )
    )
    s.append(
        FilmStock(
            name="Fuji Superia 1600",
            manufacturer="Fujifilm",
            year=2000,
            iso=1600,
            resolution=85,
            curve=_neg_curve(0.63, dmin=(0.23, 0.66, 0.98), speed=0.2, latitude=2.9, toe=0.48, sh=0.6),
            sens=Sensitivities(peaks=(637.0, 553.0, 469.0), widths=(39.0, 39.0, 35.0)),
            grain=GrainModel(rms=8.5),
            mtf_model=MTFModel(f50=38.0, adj=0.30),
            comment="Push-speed party film: coarse grain, lifted base fog.",
        )
    )

    s.append(
        FilmStock(
            name="Lomography Color Negative 800",
            manufacturer="Lomography",
            year=2010,
            iso=800,
            resolution=95,
            curve=_neg_curve(0.64, dmin=(0.22, 0.66, 0.97), latitude=3.1, toe=0.46, sh=0.6),
            sens=Sensitivities(peaks=(640.0, 552.0, 468.0), widths=(39.0, 38.0, 34.0)),
            grain=GrainModel(rms=6.5),
            mtf_model=MTFModel(f50=42.0, adj=0.28),
            comment="Warm, saturated high-speed consumer negative.",
        )
    )

    # ----------------------------------------------------- black & white
    s.append(
        FilmStock(
            name="Kodak Tri-X 400",
            manufacturer="Kodak",
            year=1954,
            iso=400,
            resolution=100,
            density_measure="bw",
            curve=_bw_curve(0.68, dmin=0.14, latitude=3.3),
            grain=GrainModel(rms=17.0, floor=0.22),
            mtf_model=MTFModel(f50=55.0, adj=0.38),
            comment="The classic high-acutance BW press film.",
        )
    )
    s.append(
        FilmStock(
            name="Ilford HP5 Plus 400",
            manufacturer="Ilford",
            year=1989,
            iso=400,
            resolution=95,
            density_measure="bw",
            curve=_bw_curve(0.62, dmin=0.12, latitude=3.5),
            grain=GrainModel(rms=15.0, floor=0.2),
            mtf_model=MTFModel(f50=50.0, adj=0.33),
        )
    )
    s.append(
        FilmStock(
            name="Ilford Delta 100",
            manufacturer="Ilford",
            year=1992,
            iso=100,
            resolution=160,
            density_measure="bw",
            curve=_bw_curve(0.70, dmin=0.10, latitude=3.0),
            grain=GrainModel(rms=9.0, floor=0.18),
            mtf_model=MTFModel(f50=90.0, adj=0.30),
        )
    )

    s.append(
        FilmStock(
            name="Fuji Acros 100",
            manufacturer="Fujifilm",
            year=2002,
            iso=100,
            resolution=180,
            density_measure="bw",
            curve=_bw_curve(0.66, dmin=0.09, latitude=3.2),
            grain=GrainModel(rms=7.0, floor=0.16),
            mtf_model=MTFModel(f50=95.0, adj=0.32),
            comment="Ultra-fine orthopanchromatic BW.",
        )
    )
    s.append(
        FilmStock(
            name="Fomapan 400",
            manufacturer="Foma",
            year=1995,
            iso=400,
            resolution=90,
            density_measure="bw",
            curve=_bw_curve(0.60, dmin=0.16, latitude=3.1),
            grain=GrainModel(rms=18.0, floor=0.25),
            mtf_model=MTFModel(f50=45.0, adj=0.36),
            comment="Gritty budget BW with pronounced grain.",
        )
    )

    s.append(
        FilmStock(
            name="Kodak T-Max 100",
            manufacturer="Kodak",
            year=1986,
            iso=100,
            resolution=200,
            density_measure="bw",
            curve=_bw_curve(0.70, dmin=0.08, latitude=3.0),
            grain=GrainModel(rms=8.0, floor=0.14),
            mtf_model=MTFModel(f50=125.0, adj=0.30),
            comment="Tabular-grain technical BW: the resolution champion.",
        )
    )
    s.append(
        FilmStock(
            name="Kodak T-Max 400",
            manufacturer="Kodak",
            year=1986,
            iso=400,
            resolution=125,
            density_measure="bw",
            curve=_bw_curve(0.67, dmin=0.10, latitude=3.2),
            grain=GrainModel(rms=10.0, floor=0.18),
            mtf_model=MTFModel(f50=80.0, adj=0.32),
            comment="Fast tabular-grain BW: Tri-X speed, Delta-class grain.",
        )
    )
    s.append(
        FilmStock(
            name="Ilford FP4 Plus 125",
            manufacturer="Ilford",
            year=1990,
            iso=125,
            resolution=145,
            density_measure="bw",
            curve=_bw_curve(0.63, dmin=0.11, latitude=3.4),
            grain=GrainModel(rms=11.0, floor=0.19),
            mtf_model=MTFModel(f50=72.0, adj=0.31),
            comment="Classic cubic-grain mid-speed BW with a gentle shoulder.",
        )
    )
    s.append(
        FilmStock(
            name="Ilford Delta 3200",
            manufacturer="Ilford",
            year=1998,
            iso=3200,
            resolution=70,
            density_measure="bw",
            curve=_bw_curve(0.58, dmin=0.22, speed=0.3, latitude=2.8),
            grain=GrainModel(rms=20.0, floor=0.30),
            mtf_model=MTFModel(f50=32.0, adj=0.34),
            comment="Ultra-speed low-light BW: heavy grain, soft gradation.",
        )
    )
    s.append(
        FilmStock(
            name="Kodak T-Max P3200",
            manufacturer="Kodak",
            year=1988,
            iso=3200,
            resolution=75,
            density_measure="bw",
            curve=_bw_curve(0.60, dmin=0.25, speed=0.25, latitude=2.9),
            grain=GrainModel(rms=18.0, floor=0.28),
            mtf_model=MTFModel(f50=36.0, adj=0.32),
            comment="T-grain push monochrome (EI 800 native): tighter grain "
            "than Delta 3200, crisper mids.",
        )
    )
    s.append(
        FilmStock(
            name="Fuji Neopan 1600",
            manufacturer="Fujifilm",
            year=1990,
            iso=1600,
            resolution=85,
            density_measure="bw",
            curve=_bw_curve(0.64, dmin=0.18, speed=0.15, latitude=2.7),
            grain=GrainModel(rms=17.9, floor=0.24),
            mtf_model=MTFModel(f50=42.0, adj=0.33),
            comment="High-speed street BW: punchy contrast, crisp grain.",
        )
    )

    s.append(
        FilmStock(
            name="Agfa APX 100",
            manufacturer="Agfa",
            year=1989,
            iso=100,
            resolution=150,
            density_measure="bw",
            curve=_bw_curve(0.64, dmin=0.10, latitude=3.3),
            grain=GrainModel(rms=10.0, floor=0.18),
            mtf_model=MTFModel(f50=80.0, adj=0.30),
            comment="Classic European cubic-grain BW with long tonality.",
        )
    )
    s.append(
        FilmStock(
            name="Kentmere Pan 400",
            manufacturer="Kentmere",
            year=2009,
            iso=400,
            resolution=95,
            density_measure="bw",
            curve=_bw_curve(0.61, dmin=0.14, latitude=3.2),
            grain=GrainModel(rms=16.0, floor=0.22),
            mtf_model=MTFModel(f50=48.0, adj=0.32),
            comment="Budget fast BW, HP5-adjacent with softer edge response.",
        )
    )
    s.append(
        FilmStock(
            name="Ilford Pan F Plus 50",
            manufacturer="Ilford",
            year=1992,
            iso=50,
            resolution=200,
            density_measure="bw",
            # Datasheet: very fine grain, high acutance, notably SHORT
            # exposure latitude for a BW negative.
            curve=_bw_curve(0.70, dmin=0.08, latitude=2.7),
            grain=GrainModel(rms=6.0, floor=0.14),
            mtf_model=MTFModel(f50=110.0, adj=0.34),
            comment="Slowest Ilford BW: finest grain, short latitude.",
        )
    )
    s.append(
        FilmStock(
            name="Ilford XP2 Super 400",
            manufacturer="Ilford",
            year=1998,
            iso=400,
            resolution=110,
            density_measure="bw",
            # Chromogenic C-41 BW: dye clouds instead of silver — smoother
            # grain than silver 400s and famously wide latitude (EI 50-800
            # on one development).
            curve=_bw_curve(0.60, dmin=0.10, latitude=4.0),
            grain=GrainModel(rms=10.0, floor=0.12),
            mtf_model=MTFModel(f50=55.0, adj=0.28),
            comment="Chromogenic BW: dye-cloud grain, huge latitude.",
        )
    )

    # ----------------------------------------------------- reversal (slide)
    s.append(
        FilmStock(
            name="Kodak Ektachrome E100",
            manufacturer="Kodak",
            year=2018,
            iso=100,
            film_type="positive",
            resolution=125,
            curve=_slide_curve(-1.65, dmax=3.8, dmin=0.15, latitude=2.2),
            dyes=DyeSet(unwanted=(0.07, 0.12, 0.03)),
            grain=GrainModel(rms=8.0),
            mtf_model=MTFModel(f50=65.0, adj=0.28),
        )
    )
    s.append(
        FilmStock(
            name="Fuji Velvia 50",
            manufacturer="Fujifilm",
            year=1990,
            iso=50,
            film_type="positive",
            resolution=160,
            curve=_slide_curve(-1.95, dmax=4.0, dmin=0.12, latitude=1.9),
            sens=Sensitivities(peaks=(646.0, 545.0, 460.0), widths=(32.0, 32.0, 29.0)),
            dyes=DyeSet(unwanted=(0.06, 0.10, 0.02)),
            grain=GrainModel(rms=9.0),
            mtf_model=MTFModel(f50=80.0, adj=0.30),
            comment="Ultra-saturated landscape slide.",
        )
    )
    s.append(
        FilmStock(
            name="Fuji Velvia 100",
            manufacturer="Fujifilm",
            year=2005,
            iso=100,
            film_type="positive",
            resolution=160,
            # One stop faster Velvia: contrast and saturation sit between
            # Velvia 50 and Provia 100F (Fuji E-6 datasheet family).
            curve=_slide_curve(-1.88, dmax=3.7, dmin=0.12, latitude=1.95),
            sens=Sensitivities(peaks=(646.0, 545.0, 460.0), widths=(33.0, 33.0, 30.0)),
            dyes=DyeSet(unwanted=(0.07, 0.11, 0.03)),
            grain=GrainModel(rms=8.0),
            mtf_model=MTFModel(f50=80.0, adj=0.30),
            comment="Velvia speed update: vivid, a touch tamer than 50.",
        )
    )
    s.append(
        FilmStock(
            name="Agfa CT Precisa 100",
            manufacturer="Agfa",
            year=2001,
            iso=100,
            film_type="positive",
            resolution=135,
            curve=_slide_curve(-1.75, dmax=3.4, dmin=0.13, latitude=2.0),
            sens=Sensitivities(peaks=(650.0, 542.0, 452.0), widths=(36.0, 35.0, 32.0)),
            dyes=DyeSet(unwanted=(0.08, 0.12, 0.04)),
            grain=GrainModel(rms=9.0),
            mtf_model=MTFModel(f50=64.0, adj=0.28),
            comment="Cool-leaning consumer E-6 (the cross-process favorite).",
        )
    )
    s.append(
        FilmStock(
            name="Fuji Provia 100F",
            manufacturer="Fujifilm",
            year=2001,
            iso=100,
            film_type="positive",
            resolution=140,
            curve=_slide_curve(-1.7, dmax=3.7, dmin=0.13, latitude=2.1),
            grain=GrainModel(rms=8.0),
            mtf_model=MTFModel(f50=70.0, adj=0.28),
        )
    )
    s.append(
        FilmStock(
            name="Fuji Astia 100F",
            manufacturer="Fujifilm",
            year=2003,
            iso=100,
            film_type="positive",
            resolution=140,
            curve=_slide_curve(-1.5, dmax=3.4, dmin=0.12, latitude=2.35),
            dyes=DyeSet(unwanted=(0.04, 0.07, 0.02)),
            grain=GrainModel(rms=7.0),
            mtf_model=MTFModel(f50=68.0, adj=0.24),
            comment="The soft portrait slide: lowest-contrast E-6, gentle skin.",
        )
    )

    s.append(
        FilmStock(
            name="Kodak Kodachrome 64",
            manufacturer="Kodak",
            year=1974,
            iso=64,
            film_type="positive",
            resolution=100,
            curve=_slide_curve(-1.85, dmax=3.7, dmin=0.15, latitude=2.0),
            sens=Sensitivities(peaks=(650.0, 545.0, 458.0), widths=(30.0, 31.0, 28.0)),
            dyes=DyeSet(unwanted=(0.05, 0.08, 0.02)),
            grain=GrainModel(rms=10.0),
            mtf_model=MTFModel(f50=63.0, adj=0.34),
            comment="The archival slide: deep reds, punchy micro-contrast.",
        )
    )

    # ----------------------------------------------------- print media
    s.append(
        FilmStock(
            name="Fuji Crystal Archive Maxima",
            manufacturer="Fujifilm",
            year=2014,
            stage="print",
            film_type="paper",
            medium="paper",
            iso=0,
            resolution=120,
            curve=_paper_curve(2.9, dmin=0.06, dmax=2.45),
            sens=Sensitivities(peaks=(695.0, 552.0, 472.0), widths=(30.0, 32.0, 30.0)),
            dyes=DyeSet(peaks=(650.0, 542.0, 442.0), unwanted=(0.06, 0.10, 0.02)),
            grain=None,
            mtf_model=None,
            comment="High-gloss silver-halide display paper.",
        )
    )
    s.append(
        FilmStock(
            name="Kodak Endura Premier",
            manufacturer="Kodak",
            year=2012,
            stage="print",
            film_type="paper",
            medium="paper",
            iso=0,
            resolution=110,
            curve=_paper_curve(2.7, dmin=0.07, dmax=2.30),
            sens=Sensitivities(peaks=(700.0, 550.0, 470.0), widths=(32.0, 33.0, 31.0)),
            dyes=DyeSet(peaks=(652.0, 545.0, 444.0), unwanted=(0.07, 0.11, 0.03)),
            grain=None,
            mtf_model=None,
        )
    )
    s.append(
        FilmStock(
            name="Kodak Vision Premier 2393",
            manufacturer="Kodak",
            year=2002,
            stage="print",
            film_type="positive",
            iso=0,
            resolution=150,
            curve=_paper_curve(3.1, dmin=0.05, dmax=3.9),
            sens=Sensitivities(peaks=(690.0, 548.0, 465.0), widths=(28.0, 30.0, 28.0)),
            dyes=DyeSet(peaks=(655.0, 544.0, 443.0), unwanted=(0.05, 0.09, 0.02)),
            grain=None,
            mtf_model=None,
            comment="Premium motion-picture print stock (projection contrast).",
        )
    )
    s.append(
        FilmStock(
            name="Ilford Multigrade IV RC",
            manufacturer="Ilford",
            year=1995,
            stage="print",
            film_type="paper",
            medium="paper",
            iso=0,
            resolution=100,
            density_measure="bw",
            curve=_bw_paper_curve(2.0, dmin=0.06, dmax=2.15),
            grain=None,
            mtf_model=None,
            comment="Silver-gelatin BW enlarging paper (grade 2 contrast).",
        )
    )
    s.append(
        FilmStock(
            name="Ilford Multigrade IV RC grade 4",
            manufacturer="Ilford",
            year=1995,
            stage="print",
            film_type="paper",
            medium="paper",
            iso=0,
            resolution=100,
            density_measure="bw",
            alias=("Multigrade hard",),
            curve=_bw_paper_curve(3.1, dmin=0.06, dmax=2.2),
            grain=None,
            mtf_model=None,
            comment="Hard-grade BW paper for flat negatives.",
        )
    )
    s.append(
        FilmStock(
            name="Kodak 2383",
            manufacturer="Kodak",
            year=1998,
            stage="print",
            film_type="positive",
            iso=0,
            resolution=150,
            curve=_paper_curve(3.0, dmin=0.06, dmax=3.7),
            sens=Sensitivities(peaks=(690.0, 548.0, 465.0), widths=(29.0, 31.0, 29.0)),
            dyes=DyeSet(peaks=(655.0, 544.0, 443.0), unwanted=(0.06, 0.10, 0.03)),
            grain=None,
            mtf_model=None,
            comment="The standard cine print emulation target.",
        )
    )
    return s


# --------------------------------------------------------------- provenance
#
# Data grounding for every stock: which parameters adopt PUBLISHED datasheet
# figures verbatim (measure + source named) and which are class estimates
# positioned against the published scale. Conventions:
#
# * "rms" = diffuse RMS granularity x1000 (48 um aperture, read at D=1.0) —
#   the measure GrainModel.rms is defined in; Kodak B&W and Fuji E-6/C-41
#   datasheets publish it directly. Kodak color negatives after ~2006 moved
#   to Print Grain Index (PGI) and publish no RMS — those entries are class
#   estimates consistent with the PGI ordering, flagged "est".
# * "MTF50" = frequency of 50% response read off the published MTF chart
#   (chart reads carry ~10% reading error; the anchor test allows 15%).
# * "CI" = contrast index / mid-scale gamma aim from the datasheet curves.
#
# Zero-egress caveat: figures are cited from the published datasheets as
# known to the authors; the sheet identifiers name the document so a reader
# with access can check them.
PROVENANCE = {
    "Kodak Portra 400": "PGI era (Kodak E-4050, 2010): no RMS published — rms 4.3 est from Kodak's 'finest grain at 400' positioning; MTF50 ~50 lp/mm chart read; CI aim ~0.60 (C-41).",
    "Kodak Portra 160": "PGI era (E-4051): rms 3.2 est (finer than Portra 400 per PGI); MTF50 ~60 chart read; CI ~0.58.",
    "Kodak Portra 800": "PGI era (E-4040): rms 5.9 est; MTF50 ~44 chart read.",
    "Kodak Ektar 100": "PGI era (E-4046): 'world's finest grain color negative' — rms 2.6 est at the bottom of the C-41 scale; MTF50 ~80 chart read; higher CI ~0.72 per curves.",
    "Kodak Gold 200": "Pre-PGI Gold 200 sheet listed Status-M-style rms ~4.4 (adopted); consumer CI ~0.70.",
    "Fuji Pro 400H": "Fuji AF3-065E: RMS granularity 4 (adopted); CI ~0.60; MTF50 ~50 chart read.",
    "Fuji Superia X-Tra 400": "Fuji consumer sheets publish no RMS for X-Tra — rms 5.2 est (coarser than Pro 400H, finer than 1600 lines).",
    "Kodak Vision3 50D": "Kodak H-1-5203: granularity published as curves, not one number — rms 2.4 est from the curve class (finest Vision3); CI aim 0.56-0.59 per sheet.",
    "Kodak Vision3 250D": "H-1-5207: rms 3.4 est from granularity-curve class; CI aim ~0.57.",
    "Kodak Vision3 500T": "H-1-5219: rms 4.6 est from granularity-curve class; CI aim ~0.57.",
    "Kodak Vision3 200T": "H-1-5213: rms 3.0 est from granularity-curve class; CI aim ~0.57.",
    "CineStill 800T": "5219 respooled without rem-jet: Vision3 500T figures +1 stop push class; halation strength is the signature (no anti-halation layer).",
    "Fuji C200": "No published RMS — rms 5.0 est in the consumer-200 class.",
    "Agfa Vista 200": "No published RMS — rms 5.2 est, consumer-200 class.",
    "Kodak Ultramax 400": "PGI era: rms 5.6 est (consumer 400, coarser than Portra 400).",
    "Kodak ColorPlus 200": "No modern sheet — rms 5.0 est, Gold-class.",
    "Kodak Aerocolor IV 125": "Kodak aerial sheet (SO-125): no masking couplers (strength 0 adopted), higher gamma ~0.75 per curves; rms 3.9 est.",
    "Fuji Natura 1600": "Fuji sheet (AF3-155E): no RMS published — rms 8.2 est, fastest C-41 class.",
    "Kodak Portra 160 NC": "Pre-2010 E-186: PGI era — rms 3.4 est; NC = neutral-contrast CI ~0.56.",
    "Kodak Portra 160 VC": "Pre-2010 E-186: rms 3.6 est; VC = vivid-contrast CI ~0.68.",
    "Fuji Superia 1600": "No published RMS — rms 8.5 est, consumer-1600 class.",
    "Lomography Color Negative 800": "No datasheet — rms 6.5 est between Portra 800 and Natura 1600.",
    "Kodak Tri-X 400": "Kodak F-4017: diffuse rms granularity 17 (PUBLISHED, adopted); resolving power 50/100 lp/mm; CI aim 0.56-0.60; MTF50 ~55 chart read.",
    "Ilford HP5 Plus 400": "Ilford publishes no RMS — rms 15 est on the published Kodak scale (slightly finer than Tri-X per side-by-side reputation); G-bar aim ~0.62.",
    "Ilford Delta 100": "No RMS published — rms 9 est (T-grain 100 class, a touch coarser than T-Max 100's published 8); MTF50 ~90 chart read.",
    "Fuji Acros 100": "Fuji AF3-402E: RMS granularity 7 (PUBLISHED, adopted) — 'finest grain among ISO-100 B&W'; MTF50 ~95 chart read.",
    "Fomapan 400": "No RMS published — rms 18 est (classic cubic 400, coarser than Tri-X).",
    "Kodak T-Max 100": "Kodak F-4016: diffuse rms granularity 8 (PUBLISHED, adopted); resolving power 63/200 lp/mm; MTF50 ~125 chart read (adopted).",
    "Kodak T-Max 400": "Kodak F-4043: diffuse rms granularity 10 (PUBLISHED, adopted); resolving power 50/125; MTF50 ~80 chart read.",
    "Ilford FP4 Plus 125": "No RMS published — rms 11 est (cubic 125, between Delta 100 and HP5).",
    "Ilford Delta 3200": "No RMS published — rms 20 est (>= T-Max P3200's published 18; Ilford's own 'grainier than TMZ' positioning).",
    "Kodak T-Max P3200": "Kodak F-4046: diffuse rms granularity 18 (PUBLISHED, adopted); EI 800 native emulsion.",
    "Fuji Neopan 1600": "No RMS published — rms 17.9 est (between Tri-X 17 and P3200 18, placed so the RENDERED amplitude ordering matches the documented P3200 > Neopan > Tri-X once each curve's density range folds in).",
    "Agfa APX 100": "No RMS published — rms 10 est (cubic 100 class).",
    "Kentmere Pan 400": "No RMS published — rms 16 est (budget 400, HP5-adjacent, slightly coarser).",
    "Ilford Pan F Plus 50": "No RMS published — rms 6 est (finest conventional Ilford; below Acros' published 7); short latitude per datasheet curves.",
    "Ilford XP2 Super 400": "No RMS published — rms 10 est (chromogenic dye clouds, smoother than silver 400s); latitude EI 50-800 per datasheet.",
    "Kodak Ektachrome E100": "Kodak E100 sheet (2018): rms granularity 8 (PUBLISHED, adopted); D-max ~3.8 per curves; MTF50 ~65 chart read.",
    "Fuji Velvia 50": "Fuji AF3-012E: RMS granularity 9 (PUBLISHED, adopted); resolving power 80/160 lp/mm; D-max ~4.0 per sheet (adopted); highest-saturation E-6.",
    "Fuji Velvia 100": "Fuji AF3-219E: RMS granularity 8 (PUBLISHED, adopted).",
    "Agfa CT Precisa 100": "No reliable RMS figure — rms 9 est (consumer E-6 class).",
    "Fuji Provia 100F": "Fuji AF3-036E: RMS granularity 8 (PUBLISHED, adopted); resolving power 60/140 lp/mm; D-max ~3.7 (adopted).",
    "Fuji Astia 100F": "Fuji AF3-103E: RMS granularity 7 (PUBLISHED, adopted); lowest-contrast Fuji E-6.",
    "Kodak Kodachrome 64": "Kodak P-1170 (archival): rms ~10 (adopted from the archival sheet; K-14 process).",
    "Fuji Crystal Archive Maxima": "RA-4 paper: gamma ~2.9 / D-max ~2.6 per Fuji's published paper curves (chart read).",
    "Kodak Endura Premier": "RA-4 paper (E-4021): gamma ~2.8 / D-max ~2.4 chart read.",
    "Kodak Vision Premier 2393": "Kodak H-1-2393: print-film gamma ~3.1, D-max >= 4.0 per published curves.",
    "Kodak 2383": "Kodak H-1-2383: print-film gamma ~3.0, D-max ~3.9 per published curves.",
    "Ilford Multigrade IV RC": "Ilford MGIV sheet: grade-2 ISO(R) ~ paper gamma ~2.0; D-max ~2.1 chart read.",
    "Ilford Multigrade IV RC grade 4": "Same sheet, grade-4 filtered: gamma ~3.1, shorter ISO(R).",
}


@lru_cache(maxsize=1)
def load_film_stocks() -> dict[str, FilmStock]:
    """Name -> FilmStock database (the reference's film_loader equivalent),
    each entry carrying its data-grounding note (PROVENANCE). The
    program's overlay of user-imported stocks is left out: the benchmark
    runs the parametric database alone."""
    import dataclasses

    stocks = {
        stock.name: dataclasses.replace(
            stock, provenance=PROVENANCE.get(stock.name, "")
        )
        for stock in _stocks()
    }
    return stocks


def camera_stocks() -> dict[str, FilmStock]:
    return {k: v for k, v in load_film_stocks().items() if v.stage == "camera"}


def print_stocks() -> dict[str, FilmStock]:
    return {k: v for k, v in load_film_stocks().items() if v.stage == "print"}
