"""The traffic generator: frame streams made on the device from ``--seed``
and a mix's parameters (``traffic/<mix>.json``).

A stream is a loop of scenes (``scenes``: each a mean level and a wave
amplitude), ``pool`` frames each, taken in turn: frame k of a scene is its
mean plus a sum of ``waves`` plane waves (wavelengths, directions and
phases drawn from the seed for each scene) panned ``pan`` px to the right
per frame, under a static HUD box with a fixed pattern of bars. ``pan`` is
drawn per stream, uniformly from ``pan_px``. The step from a scene's last
frame to the next scene's first is a scene cut, one pair in ``pool`` (the
scenes differ in level and contrast, so the flow-compensated SSIM gate
sees the cut; two pans of one plane-wave texture it would align). Stream
j starts at frame j * pool / streams of scene j mod len(scenes), so the
streams' cuts fall on different steps.

A step g takes one pair from each stream: frames ((o_j + g) mod L,
(o_j + g + 1) mod L), L = pool * len(scenes). Every seed gives the same
sizes, pairs and cuts: the seed changes textures, speeds and weights, not
the work.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from portbench.weights import seed_of


class Streams:
    """The frame pools of one run: uint8 [S, pool, H, W, 3] on the device."""

    def __init__(self, mix: dict, seed: int, hw: Tuple[int, int], device):
        self.mix = mix
        self.n = int(mix["streams"])
        self.pool = int(mix["pool"])
        self.scenes = mix["scenes"]
        self.period = self.pool * len(self.scenes)
        self.hw = tuple(hw)
        self.offsets = [j * self.pool // self.n + (j % len(self.scenes)) * self.pool
                        for j in range(self.n)]
        self.pans = []
        h, w = self.hw
        self.frames = torch.empty((self.n, self.period, h, w, 3), dtype=torch.uint8,
                                  device=device)
        for j in range(self.n):
            rng = np.random.default_rng(seed_of(seed, 100 + j))
            pan = float(rng.uniform(*mix["pan_px"]))
            self.pans.append(pan)
            for i, scene in enumerate(self.scenes):
                self._fill(j, i * self.pool, scene, rng, pan, device)

    def _fill(self, j: int, first: int, scene: dict, rng, pan: float, device):
        h, w = self.hw
        waves = int(self.mix["waves"])
        k = 2 * np.pi / rng.uniform(*self.mix["wavelength_px"], waves)
        ang = rng.uniform(0, 2 * np.pi, waves)
        phase = torch.tensor(rng.uniform(0, 2 * np.pi, (waves, 3)), dtype=torch.float32,
                             device=device)
        kx = torch.tensor(k * np.cos(ang), dtype=torch.float32, device=device)
        ky = torch.tensor(k * np.sin(ang), dtype=torch.float32, device=device)
        ys = torch.arange(h, dtype=torch.float32, device=device)
        xs = torch.arange(w, dtype=torch.float32, device=device)
        base = kx[:, None, None] * xs[None, None, :] + ky[:, None, None] * ys[None, :, None]
        hy0, hx0, hh, hw_ = (int(round(f * s)) for f, s in
                             zip(self.mix["hud_box"], (h, w, h, w)))
        bars = ((torch.arange(hw_, device=device) // max(hw_ // 16, 1)) % 2).float()
        hud = torch.tensor(self.mix["hud_rgb"], dtype=torch.float32, device=device)
        hud = hud[None, None, :] * (1.0 - 0.6 * bars[None, :, None]).expand(hh, hw_, 1)
        mean, amp = float(scene["mean"]), float(scene["amplitude"])
        for i in range(self.pool):
            arg = base - (kx * (pan * i))[:, None, None]
            f = mean + amp * torch.sin(arg[:, None] + phase[:, :, None, None]).sum(0)
            f = f.permute(1, 2, 0).contiguous()
            f[hy0:hy0 + hh, hx0:hx0 + hw_] = hud
            self.frames[j, first + i] = torch.clamp(torch.floor(f * 255.0 + 0.5), 0,
                                                    255).to(torch.uint8)

    def indices(self, g: int) -> List[int]:
        """The first frame of each stream's pair at step g."""
        return [(o + g) % self.period for o in self.offsets]

    def is_cut(self, g: int) -> bool:
        return any(i % self.pool == self.pool - 1 for i in self.indices(g))

    def pair(self, g: int):
        """(x0, x1) float32 [S,H,W,3] in [0, 1] of step g."""
        idx = self.indices(g)
        a = torch.stack([self.frames[j, i] for j, i in enumerate(idx)])
        b = torch.stack([self.frames[j, (i + 1) % self.period] for j, i in enumerate(idx)])
        return a.float() / 255.0, b.float() / 255.0

    def history(self, g: int, ring: int = 10) -> list:
        """x0 of the steps before g that the HUD ring still holds at g
        (oldest first), each [S,H,W,3]."""
        return [self.pair(k)[0] for k in range(max(0, g - ring + 1), g)]

