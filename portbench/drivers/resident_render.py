"""Resident render: seeded mosaics held on the device, rendered one after
another by ``render_chain_from_mosaic`` to uint8 on the device.

Traffic keys: ``frames`` (mosaics made at set-up, cycled). A request ends
when its frame is complete on the device (synchronised), as a roll
export's render thread waits before its download; its work is the frame's
output megapixels (``mp``).
"""

from __future__ import annotations

import gc

import numpy as np
import torch

from portbench import inputs
from portbench import settings as st
from portbench.compare import CodeGap
from portbench.ref import process as rproc
from portbench.ref.chain import Ref


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device, control: bool = False):
        from raw2film_tpu_torch.film.loader import load_film_stocks
        from raw2film_tpu_torch.pipeline.processor import Processor
        from raw2film_tpu_torch.pipeline.render import build_render_config, render_chain_from_mosaic

        self.config, self.device, self.control = config, torch.device(device), control
        f, s = config["frame"], config["settings"]
        self.h, self.w = f["height"], f["width"]
        self.pattern = f["pattern"]
        self.norm = np.asarray([f["black_level"], 1.0 / max(f["white_level"] - f["black_level"], 1.0)], np.float32)
        self.cam = inputs.cam_to_xyz(f["color_matrix"])
        n = int(traffic["frames"])
        gen = inputs.generator(seed, self.device)
        self.mosaics = inputs.mosaics(n, self.h, self.w, f["black_level"], f["white_level"], gen, self.device)
        self.seeds = st.seeds(seed, n)
        self.scale = st.scale(config)
        self.kept = st.Reservoir(seed)
        self.i = 0
        if control:
            self.ref = Ref(tf32=True)
            self.film = rproc.film_params(s, self.device)
            self.look = rproc.look(s, self.film, self.scale)
        else:
            stocks = load_film_stocks()
            neg, prt = stocks[s["negative_film"]], stocks[s["print_film"]]
            merged = st.merged(s)
            self.proc = Processor(device=self.device)
            self.bundle, mode = self.proc.load_film_bundle(neg, prt, merged)
            self.cfg = build_render_config(neg, prt, mode, self.scale, merged)
            self.render_fn = render_chain_from_mosaic
        self.render(0)  # every mosaic has the one shape: one render warms it
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def render(self, j: int) -> torch.Tensor:
        if self.control:
            return self.ref.render_mosaic(self.mosaics[j], self.cam, 1.0, self.norm, self.pattern,
                                          self.film, self.look, self.seeds[j])
        return self.render_fn(self.mosaics[j], self.cam, self.bundle, self.cfg, self.seeds[j],
                              self.pattern, 1.0, None, self.norm, device=self.device)

    def step(self) -> dict:
        j = self.i % len(self.mosaics)
        self.i += 1
        out = self.render(j)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.kept.offer(j, out)
        return {"mp": self.h * self.w / 1e6}

    def release(self) -> None:
        """Drop the program's state; the inputs and the kept answers stay."""
        for k in ("proc", "bundle", "cfg", "ref", "film", "look"):
            self.__dict__.pop(k, None)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        s = self.config["settings"]
        ref = Ref()
        film = rproc.film_params(s, self.device)
        lk = rproc.look(s, film, self.scale)
        gap = CodeGap()
        for j in sorted(self.kept.kept):
            want = ref.render_mosaic(self.mosaics[j], self.cam, 1.0, self.norm, self.pattern, film, lk, self.seeds[j])
            gap.add(self.kept.kept.pop(j), want)
            del want
        return gap.numbers()
