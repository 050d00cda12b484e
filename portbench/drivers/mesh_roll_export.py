"""Roll export over a batch mesh: a roll of seeded DNGs rendered by one
``Processor.process_batch(mesh=...)`` call a request, at the batch export's
settings, each frame on its batch row's card.

Configuration keys: ``roll_frames`` (the DNGs written at set-up: one call's
roll) and ``layout`` (``cards``, and ``mesh``: its ``batch`` and ``space``;
the mesh spans the first ``cards`` CUDA devices, or, on the CPU, the CPU
repeated). Traffic keys: ``process`` (the export's keywords, as
``roll_export``'s) and ``warm_frames`` (the warm-up call's roll: one frame
a batch row, so that every card loads its kernels and builds its bundle).
A request draws its own grain seed, returns the roll's uint8 (H, W, 3)
images on the host, and its work is the roll's frames; image j of a call
with seed s takes the grain seed of fold_in(PRNGKey(s), j). The check keeps
one frame of each batch row, drawn from the seed, so every card's answers
are compared in every run.
"""

from __future__ import annotations

import gc
import os
import random
import shutil
import tempfile

import numpy as np
import torch

from portbench import bench, inputs
from portbench import settings as st
from portbench.compare import CodeGap
from portbench.ref import process as rproc
from portbench.ref.chain import Ref

# the single-frame export's reference recipe, from this benchmark's own files
roll_export = bench.load_driver("roll_export", os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class _GrainSeed:
    """The reference with its fused render's grain seed fixed to ``grain``:
    ``roll_export.expected`` renders image 0 of a call, and a batch's image
    j takes another seed."""

    def __init__(self, ref: Ref, grain: int):
        self.ref, self.grain = ref, grain

    def render_mosaic(self, *args):
        return self.ref.render_mosaic(*args[:-1], self.grain)


def checked_frames(seed: int, n: int, rows: int) -> list[int]:
    """The frames of a roll of n whose answers the check keeps: one of each
    batch row (frame j renders on row j % rows), drawn from the run's
    seed."""
    rng = random.Random(int(seed) ^ 0xC4EC)
    return [rng.choice(range(r, n, rows)) for r in range(min(rows, n))]


def _mesh(layout: dict, device: torch.device):
    from raw2film_tpu_torch.parallel.mesh import make_mesh

    n, shape = int(layout["cards"]), layout["mesh"]
    devices = None if device.type == "cuda" else [device] * n
    return make_mesh(n, batch=int(shape["batch"]), space=int(shape["space"]), devices=devices)


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device, control: bool = False):
        from raw2film_tpu_torch.pipeline.processor import Processor

        self.config, self.device, self.control = config, torch.device(device), control
        f, s = config["frame"], config["settings"]
        n = int(config["roll_frames"])
        gen = inputs.generator(seed, self.device)
        self.mosaics = inputs.mosaics(n, f["height"], f["width"], f["black_level"], f["white_level"], gen, self.device)
        self.dir = tempfile.mkdtemp(prefix="portbench-mesh-roll-")
        self.paths = inputs.roll(self.dir, self.mosaics, f["black_level"], f["white_level"], f["color_matrix"])
        self.kwargs = st.process_kwargs(s, **traffic["process"])
        self.call_seeds = random.Random(int(seed) ^ 0xCA11)
        self.sample = checked_frames(seed, n, int(config["layout"]["mesh"]["batch"]))
        self.kept = st.Reservoir(seed)
        if control:
            self.ref = Ref(tf32=True)
        else:
            self.proc = Processor(device=self.device)
            self.mesh = _mesh(config["layout"], self.device)
            self.proc.process_batch(self.paths[: int(traffic["warm_frames"])], mesh=self.mesh, **self.kwargs)
        if self.device.type == "cuda":
            for i in range(torch.cuda.device_count()):
                torch.cuda.synchronize(i)

    def step(self) -> dict:
        call_seed = self.call_seeds.getrandbits(32)
        if self.control:
            images = {j: self._expected(self.ref, j, call_seed).cpu().numpy().transpose(1, 2, 0) for j in self.sample}
        else:
            out = self.proc.process_batch(self.paths, mesh=self.mesh, seed=call_seed, **self.kwargs)
            images = {j: out[j] for j in self.sample}
        for j in self.sample:
            self.kept.offer(j, (images[j], call_seed))
        return {"frames": len(self.paths)}

    def _expected(self, ref: Ref, j: int, call_seed: int) -> torch.Tensor:
        """The reference's (3, H, W) uint8 for image j of a call with
        ``call_seed``."""
        grain = rproc.process_grain_seed(call_seed, j)
        return roll_export.expected(_GrainSeed(ref, grain), self.config, self.mosaics[j], call_seed, self.device)

    def release(self) -> None:
        for k in ("proc", "mesh", "ref"):
            self.__dict__.pop(k, None)
        shutil.rmtree(self.dir, ignore_errors=True)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        ref = Ref()
        gap = CodeGap()
        for j in sorted(self.kept.kept):
            image, call_seed = self.kept.kept.pop(j)
            gap.add(np.asarray(image), self._expected(ref, j, call_seed).movedim(0, -1))
        return gap.numbers()
