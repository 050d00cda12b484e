"""A configuration's settings as the program's entry points take them.

A configuration file holds the user's settings by upstream's names
(``settings``: the profile and image parameters, the stocks by name) and
the frame its sensor delivers (``frame``). These helpers derive from them
the keyword arguments of ``Processor.process`` and the merged parameter
dict that ``Processor.load_film_bundle`` and ``build_render_config`` read,
as ``process()`` itself derives them.
"""

from __future__ import annotations

import random

# The merged keys ``Processor.process`` forwards to the bundle and the
# render configuration.
MERGED_KEYS = (
    "exp_kelvin", "tint", "exp_comp", "push_pull", "color_masking", "red_light", "green_light",
    "blue_light", "projector_kelvin", "shadow_comp", "sat_adjust", "inversion_gamma",
    "idealized_curve", "inversion", "white_balance", "white_clip", "gamma_func",
    "halation_intensity", "halation_green_factor", "highlight_burn", "halation", "halation_size",
    "sharpness", "sharpening_strength", "sharpening_sigma", "grain", "grain_size", "grain_sigma",
    "burn_scale", "chroma_nr", "mtf_fidelity",
)
# Settings that are not ``process()`` keywords.
NOT_KWARGS = ("film_format", "profile")


def merged(settings: dict) -> dict:
    out = {k: settings.get(k, False if k == "inversion" else None) for k in MERGED_KEYS}
    if out["color_masking"] is None:
        out["color_masking"] = 1.0
    missing = [k for k, v in out.items() if v is None]
    if missing:
        raise KeyError(f"settings lack {missing}")
    return out


def process_kwargs(settings: dict, **over) -> dict:
    return {k: v for k, v in {**settings, **over}.items() if k not in NOT_KWARGS}


def scale(config: dict) -> float:
    """Pixels per mm on film of the full frame."""
    f, s = config["frame"], config["settings"]
    return max(f["height"], f["width"]) / max(s["frame_width"], s["frame_height"])


def seeds(seed: int, n: int) -> list[int]:
    """n uint32 grain seeds drawn from the run's seed."""
    rng = random.Random(int(seed))
    return [rng.getrandbits(32) for _ in range(n)]


class Reservoir:
    """A uniform sample, drawn from the seed, of one answer per key (the
    answers of the window that the check compares): the i-th answer of a key
    replaces the kept one with probability 1/i."""

    def __init__(self, seed: int):
        self.rng = random.Random(int(seed) ^ 0x5EED)
        self.count: dict = {}
        self.kept: dict = {}

    def offer(self, key, answer) -> None:
        n = self.count.get(key, 0) + 1
        self.count[key] = n
        if self.rng.random() * n < 1.0:
            self.kept[key] = answer
