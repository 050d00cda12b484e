"""Adobe/Resolve .cube 3D LUT read/write.

Interop surface for the LUT-centric ecosystem around the reference (its
``create_lut`` has a ``cube=True`` mode; reference call signature at
src/raw2film/cpu_processor.py:232-253). Exported LUTs carry the full
negative->print chain over density/linear domains so third-party tools can
apply the film look; imported LUTs apply through
:func:`raw2film_tpu_torch.ops.lut.apply_lut_3d_tetrahedral`.
"""

from __future__ import annotations

import numpy as np


def write_cube(
    path: str,
    lut: np.ndarray,
    title: str = "raw2film-tpu",
    domain_min: tuple = (0.0, 0.0, 0.0),
    domain_max: tuple = (1.0, 1.0, 1.0),
) -> None:
    """lut (N, N, N, 3) indexed [r, g, b] -> .cube (blue-fastest order)."""
    n = lut.shape[0]
    with open(path, "w") as f:
        f.write(f'TITLE "{title}"\n')
        f.write(f"LUT_3D_SIZE {n}\n")
        f.write("DOMAIN_MIN " + " ".join(f"{v:g}" for v in domain_min) + "\n")
        f.write("DOMAIN_MAX " + " ".join(f"{v:g}" for v in domain_max) + "\n")
        # .cube iterates red fastest: index order b-major when writing
        # lut[r,g,b]; emit with r fastest.
        data = np.asarray(lut, np.float32).transpose(2, 1, 0, 3).reshape(-1, 3)
        for rgb in data:
            f.write(f"{rgb[0]:.6f} {rgb[1]:.6f} {rgb[2]:.6f}\n")


def read_cube(path: str) -> tuple[np.ndarray, tuple, tuple]:
    """-> (lut (N, N, N, 3) indexed [r, g, b], domain_min, domain_max)."""
    n = None
    dmin = (0.0, 0.0, 0.0)
    dmax = (1.0, 1.0, 1.0)
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            key = parts[0].upper()
            if key == "LUT_3D_SIZE":
                n = int(parts[1])
            elif key == "DOMAIN_MIN":
                dmin = tuple(float(x) for x in parts[1:4])
            elif key == "DOMAIN_MAX":
                dmax = tuple(float(x) for x in parts[1:4])
            elif key in ("TITLE", "LUT_1D_SIZE"):
                continue
            else:
                try:
                    rows.append([float(x) for x in parts[:3]])
                except ValueError:
                    continue
    if n is None or len(rows) != n**3:
        raise ValueError(f"{path}: malformed .cube (size {n}, {len(rows)} rows)")
    data = np.asarray(rows, np.float32).reshape(n, n, n, 3)  # b-major, r fastest
    return data.transpose(2, 1, 0, 3), dmin, dmax


def export_film_lut(
    path: str,
    negative_film,
    print_film=None,
    size: int = 33,
    input_encoding: str = "linear",
    **chain_kwargs,
) -> None:
    """Bake the film chain into a .cube taking encoded camera RGB.

    ``input_encoding``: 'linear' (Rec709-primaries linear light in [0,1],
    domain scaled x4 like the density LUTs) or 'density' (the raw
    create_lut domain, matching the reference's LUT semantics).
    """
    from raw2film_tpu_torch.data import REC709_TO_XYZ
    from raw2film_tpu_torch.film import chain as fchain
    from raw2film_tpu_torch.film.luts import create_lut

    if input_encoding == "density":
        lut = create_lut(negative_film, print_film, size=size, **chain_kwargs)
        write_cube(path, lut, title=f"{negative_film.name} density domain")
        return

    neg_p = fchain.build_negative_params(negative_film)
    inversion = print_film is None and negative_film.film_type == "negative"
    prt_p = fchain.build_print_params(
        negative_film, print_film, inversion=inversion, neg_params=neg_p,
        **{k: v for k, v in chain_kwargs.items() if k in (
            "red_light", "green_light", "blue_light", "projector_kelvin",
            "shadow_comp", "inversion_gamma", "idealized_curve", "white_balance",
        )},
    )
    out_p = fchain.build_output_params(
        negative_film, print_film, prt_p, neg_p,
        **{k: v for k, v in chain_kwargs.items() if k in (
            "projector_kelvin", "sat_adjust", "gamma_func", "white_clip",
        )},
    )
    g = np.linspace(0.0, 1.0, size) ** 2.0 * 4.0  # shaped linear domain
    r, gg, b = np.meshgrid(g, g, g, indexing="ij")
    rgb = np.stack([r, gg, b]).reshape(3, size, size * size)
    xyz = np.einsum("ij,jhw->ihw", REC709_TO_XYZ, rgb)
    out = fchain.render_oracle(xyz, neg_p, prt_p, out_p)
    lut = out.reshape(3, size, size, size).transpose(1, 2, 3, 0)
    write_cube(
        path,
        lut,
        title=f"{negative_film.name}"
        + (f" -> {print_film.name}" if print_film else " (inversion)"),
    )
