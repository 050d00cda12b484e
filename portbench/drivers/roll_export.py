"""Roll export: a roll of seeded DNGs, each rendered by
``Processor.process`` at full resolution, as a batch export does it.

Traffic keys: ``frames`` (DNGs written at set-up under the temporary
directory, cycled) and ``process`` (the export's keywords over the
configuration's settings: full size, no cache, lens correction on; with no
lens profile for the file this is the fused path). A request returns the
uint8 (H, W, 3) image on the host; its work is one frame. The file encode
is left out: it is PIL, not the port.
"""

from __future__ import annotations

import gc
import shutil
import tempfile

import numpy as np
import torch

from portbench import inputs
from portbench import settings as st
from portbench.compare import CodeGap
from portbench.ref import process as rproc
from portbench.ref.chain import Ref


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device, control: bool = False):
        from raw2film_tpu_torch.pipeline.processor import Processor

        self.config, self.device, self.control = config, torch.device(device), control
        f, s = config["frame"], config["settings"]
        n = int(traffic["frames"])
        gen = inputs.generator(seed, self.device)
        self.mosaics = inputs.mosaics(n, f["height"], f["width"], f["black_level"], f["white_level"], gen, self.device)
        self.dir = tempfile.mkdtemp(prefix="portbench-roll-")
        self.paths = inputs.roll(self.dir, self.mosaics, f["black_level"], f["white_level"], f["color_matrix"])
        self.seeds = st.seeds(seed, n)
        self.kwargs = st.process_kwargs(s, **traffic["process"])
        self.kept = st.Reservoir(seed)
        self.i = 0
        if control:
            self.ref = Ref(tf32=True)
        else:
            self.proc = Processor(device=self.device)
        self.frame(0)  # every frame has the one shape: one warms it
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def frame(self, j: int) -> np.ndarray:
        if self.control:
            return expected(self.ref, self.config, self.mosaics[j], self.seeds[j], self.device).cpu().numpy().transpose(1, 2, 0)
        return self.proc.process(self.paths[j], seed=self.seeds[j], **self.kwargs)

    def step(self) -> dict:
        j = self.i % len(self.paths)
        self.i += 1
        self.kept.offer(j, self.frame(j))
        return {"frames": 1}

    def release(self) -> None:
        for k in ("proc", "ref"):
            self.__dict__.pop(k, None)
        shutil.rmtree(self.dir, ignore_errors=True)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        ref = Ref()
        gap = CodeGap()
        for j in sorted(self.kept.kept):
            gap.add(self.kept.kept.pop(j), expected(ref, self.config, self.mosaics[j], self.seeds[j], self.device).movedim(0, -1))
        return gap.numbers()


def expected(ref: Ref, config: dict, mosaic, seed: int, device) -> torch.Tensor:
    """The reference's (3, H, W) uint8 for ``process(path, seed=seed)`` of
    the DNG written from ``mosaic``."""
    f, s = config["frame"], config["settings"]
    h, w = mosaic.shape
    rows, cols = rproc.aspect_crop(h, w, s["frame_width"] / s["frame_height"])
    if (rows.stop - rows.start, cols.stop - cols.start) != (h, w):
        raise ValueError("the reference renders frames of the configuration's own aspect only")
    black, white = f["black_level"], f["white_level"]
    inv_range = 1.0 / max(white - black, 1.0)
    cam = inputs.cam_to_xyz(f["color_matrix"])
    gain = rproc.fused_gain(mosaic.cpu().numpy(), f["pattern"], cam, float(black), inv_range, inputs.written_meta())
    film = rproc.film_params(s, device)
    look = rproc.look(s, film, st.scale(config))
    norm = np.asarray([black, inv_range], np.float32)
    return ref.render_mosaic(mosaic, cam, gain, norm, f["pattern"], film, look, rproc.process_grain_seed(seed, 0))
