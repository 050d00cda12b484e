"""The CLI's roll export: ``raw2film-tpu-torch <folder>`` with no flags, one
call of its export function (``cli.export_files``) a request.

Configuration keys: ``roll_frames`` (the DNGs written at set-up: one call's
roll) and ``settings`` (upstream's defaults; a setting that differs from
the CLI's own default is passed as its flag). Traffic keys: ``jobs`` (the
decode pool's threads, ``--jobs``), ``warm_frames`` (the warm-up call's
roll) and ``checked_per_call`` (the frames of each call offered to the
check, drawn from the seed). A request renders the roll's frames in the
same order through the CLI's decode pool (``BatchRunner``) into one
long-lived ``Processor``; the export callback keeps each uint8 (H, W, 3)
frame and writes no file (the JPEG encode is PIL, not the port). Its work
is the roll's frames. The CLI renders every frame with grain seed 0 as
image 0, so a frame's answer is the same in every call.
"""

from __future__ import annotations

import gc
import random
import shutil
import tempfile

import numpy as np
import torch

from portbench import inputs
from portbench import settings as st
from portbench.compare import CodeGap
from portbench.ref import staged
from portbench.ref.chain import Ref

CLI_SEED = 0  # the CLI's --seed default


def argv(folder: str, settings: dict, jobs: int) -> list[str]:
    """The CLI's arguments: the folder, ``--jobs`` and a flag for each
    setting that differs from the CLI's default (none at upstream's
    defaults)."""
    from raw2film_tpu_torch.pipeline.params import merge_params

    out = [folder, "--jobs", str(int(jobs))]
    for key, default in merge_params().items():
        value = settings[key]
        if value != default:
            out += ["--" + key.replace("_", "-"), str(value).lower() if isinstance(value, bool) else str(value)]
    return out


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device, control: bool = False):
        from raw2film_tpu_torch.cli import export_files, parse_args
        from raw2film_tpu_torch.pipeline.processor import Processor

        self.config, self.device, self.control = config, torch.device(device), control
        f, s = config["frame"], config["settings"]
        n = int(config["roll_frames"])
        gen = inputs.generator(seed, self.device)
        self.mosaics = inputs.mosaics(n, f["height"], f["width"], f["black_level"], f["white_level"], gen, self.device)
        self.dir = tempfile.mkdtemp(prefix="portbench-cli-roll-")
        self.paths = inputs.roll(self.dir, self.mosaics, f["black_level"], f["white_level"], f["color_matrix"])
        self.args = parse_args(argv(self.dir, s, traffic["jobs"]))
        self.export_files = export_files
        self.per_call = int(traffic["checked_per_call"])
        self.sample = random.Random(int(seed) ^ 0xC11)
        self.kept = st.Reservoir(seed)
        if control:
            self.ref = Ref(tf32=True)
        else:
            self.proc = Processor(device=self.device)
            self.call(self.paths[: int(traffic["warm_frames"])])
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def call(self, paths: list[str]) -> dict:
        """One export of ``paths``: path -> its uint8 (H, W, 3) frame."""
        frames = {}

        def keep(image, src):
            frames[src] = image
            return src

        for r in self.export_files(self.args, paths, processor=self.proc, export=keep):
            if not r.ok:
                raise RuntimeError(f"{r.src}: {r.error}")
        return frames

    def step(self) -> dict:
        checked = self.sample.sample(range(len(self.paths)), self.per_call)
        if self.control:
            images = {j: self._expected(self.ref, j).cpu().numpy().transpose(1, 2, 0) for j in checked}
        else:
            frames = self.call(self.paths)
            images = {j: frames[self.paths[j]] for j in checked}
        for j in checked:
            self.kept.offer(j, images[j])
        return {"frames": len(self.paths)}

    def _expected(self, ref: Ref, j: int) -> torch.Tensor:
        """The reference's (3, H, W) uint8 for frame j."""
        f = self.config["frame"]
        norm = np.asarray([f["black_level"], 1.0 / max(f["white_level"] - f["black_level"], 1.0)], np.float32)
        return staged.frame(ref, self.mosaics[j], norm, inputs.cam_to_xyz(f["color_matrix"]), inputs.written_meta(),
                            self.config["settings"], CLI_SEED, self.device)

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
            gap.add(np.asarray(self.kept.kept.pop(j)), self._expected(ref, j).movedim(0, -1))
        return gap.numbers()
