"""The numbers that decide ``correct``: how many of the program's uint8
codes differ from the plain reference's, over every compared answer.

- ``codes_off_pct``: the share of all codes, in percent, that differ;
- ``worst_tile_off_pct``: the largest such share in one tile of
  :data:`TILE` x :data:`TILE` pixels (all channels), so that a fault
  confined to a small part of a frame shows too.

A largest gap in codes is not compared: the sound program's and the TF32
control's are both 1 code (PERF.md, section 2).
"""

from __future__ import annotations

import torch

TILE = 32


class CodeGap:
    def __init__(self):
        self.off = 0
        self.total = 0
        self.worst_tile = 0.0
        self.answers = 0

    def add(self, got, want) -> None:
        """``got``, ``want``: uint8 (C, H, W) or (H, W, C) of one answer."""
        got = torch.as_tensor(got).to(want.device)
        if tuple(got.shape) != tuple(want.shape) or got.dtype != torch.uint8:
            raise ValueError(f"answer {got.dtype} {tuple(got.shape)}, reference {tuple(want.shape)}")
        off = got != want
        if off.shape[-1] in (3, 4) and off.shape[0] not in (3, 4):
            off = off.movedim(-1, 0)
        self.off += int(off.sum())
        self.total += off.numel()
        c, h, w = off.shape
        per_tile = torch.nn.functional.avg_pool2d(
            off.to(torch.float32).mean(0)[None, None], TILE, ceil_mode=True
        ) if min(h, w) >= TILE else off.to(torch.float32).mean()[None]
        self.worst_tile = max(self.worst_tile, float(per_tile.max()))
        self.answers += 1

    def numbers(self) -> dict:
        if self.answers == 0:  # nothing answered: nothing can be judged right
            return {"codes_off_pct": float("inf"), "worst_tile_off_pct": float("inf")}
        return {"codes_off_pct": 100.0 * self.off / self.total, "worst_tile_off_pct": 100.0 * self.worst_tile}
