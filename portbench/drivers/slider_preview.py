"""Slider preview: one user dragging a slider in the viewer, one request
after another through ``PreviewEngine``.

Traffic keys: ``slider`` (the setting moved), ``sweep`` ([from, to, step]:
the values it steps through, cycling from a start drawn from the seed) and
``request`` (the viewer's keywords over the configuration's settings: the
preview's cap in pixels per mm). One DNG is written and decoded at set-up
(the cache the traffic needs). A request runs from ``request()`` to its
``on_frame``, and the next waits for it; its work is one frame.
"""

from __future__ import annotations

import gc
import random
import shutil
import tempfile
import threading

import numpy as np
import torch

from portbench import inputs
from portbench import settings as st
from portbench.compare import CodeGap
from portbench.ref import preview as rprev
from portbench.ref.chain import Ref

KEEP = 6  # answers compared: one drawn from each residue of the request count


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device, control: bool = False):
        from raw2film_tpu_torch.pipeline.preview import PreviewEngine
        from raw2film_tpu_torch.pipeline.processor import Processor

        self.config, self.traffic, self.device, self.control = config, traffic, torch.device(device), control
        f, s = config["frame"], config["settings"]
        gen = inputs.generator(seed, self.device)
        self.mosaic = inputs.mosaic(f["height"], f["width"], f["black_level"], f["white_level"], gen, self.device)
        self.dir = tempfile.mkdtemp(prefix="portbench-preview-")
        self.path = inputs.roll(self.dir, [self.mosaic], f["black_level"], f["white_level"], f["color_matrix"])[0]
        lo, hi, step = traffic["sweep"]
        self.values = [round(lo + k * step, 6) for k in range(int(round((hi - lo) / step)) + 1)]
        self.i = random.Random(int(seed)).randrange(len(self.values))
        self.kwargs = st.process_kwargs(s, **traffic["request"])
        self.kept = st.Reservoir(seed)
        self.n = 0
        self.got, self.errors = [], []
        self.done = threading.Event()
        if control:
            self.ref = Ref(tf32=True)
            self.xyz = reference_decode(self.ref, config, self.mosaic)
        else:
            self.engine = PreviewEngine(Processor(device=self.device), on_frame=self._on_frame,
                                        on_error=self._on_error)
        for _ in range(2):  # the decode, then a frame from the cache
            self.frame(self.values[self.i])

    def _on_frame(self, image, hist):
        self.got.append((image, hist))
        self.done.set()

    def _on_error(self, exc):
        self.errors.append(exc)
        self.done.set()

    def frame(self, value):
        if self.control:
            return rprev.frame(self.ref, self.xyz, self.config["settings"], self.traffic["request"]["max_scale"],
                               value, self.device)
        self.done.clear()
        self.engine.request(self.path, **{**self.kwargs, self.traffic["slider"]: value})
        if not self.done.wait(600):
            raise TimeoutError("no preview frame within 600 s")
        if self.errors:
            raise self.errors.pop()
        return self.got.pop()

    def step(self) -> dict:
        value = self.values[self.i % len(self.values)]
        self.i += 1
        image, hist = self.frame(value)
        self.kept.offer(self.n % KEEP, (value, image, hist))
        self.n += 1
        return {"frames": 1}

    def release(self) -> None:
        engine = self.__dict__.pop("engine", None)
        if engine is not None:
            engine.close()
        for k in ("ref", "xyz"):
            self.__dict__.pop(k, None)
        shutil.rmtree(self.dir, ignore_errors=True)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        ref = Ref()
        xyz = reference_decode(ref, self.config, self.mosaic)
        frames, strips = CodeGap(), CodeGap()
        for k in sorted(self.kept.kept):
            value, image, hist = self.kept.kept.pop(k)
            want_image, want_hist = rprev.frame(ref, xyz, self.config["settings"], self.traffic["request"]["max_scale"],
                                                value, self.device)
            frames.add(torch.as_tensor(image), torch.as_tensor(want_image))
            strips.add(torch.as_tensor(hist), torch.as_tensor(want_hist))
        out = frames.numbers()
        out["histogram_off_pct"] = strips.numbers()["codes_off_pct"]
        return out


def reference_decode(ref: Ref, config: dict, mosaic):
    f, s = config["frame"], config["settings"]
    norm = np.asarray([f["black_level"], 1.0 / max(f["white_level"] - f["black_level"], 1.0)], np.float32)
    return rprev.decoded(ref, mosaic, norm, inputs.cam_to_xyz(f["color_matrix"]), inputs.written_meta(),
                         s["frame_width"] / s["frame_height"])
