"""Cluttered-MNIST synthesis engine (a copy of `mgtpu/data/cluttered.py`,
the rebuild of the reference's `utils/mnist-cluttered/`:
mnist_cluttered.lua, utils/{task,position,transform}.lua). The sprite
transforms are PIL's (imported where they run): PIL must be installed to
synthesise cluttered-MNIST data.

Tasks (`utils/task.lua`):
  segmentation:      place ~ceil(N(nDigits, 0.5)) rotated/rescaled digits
                     with <=30% overlap constraint; target = per-class
                     mask thresholded (`task.lua:29-87`)
  spatial_transform: cluttered input <-> centered clean target
                     (`task.lua:110-156`)
  centered_transform: centered input placement too (`task.lua:158-202`)

Position samplers (`utils/position.lua`): uniform, split,
overlap_constraint (reject >0.3 overlap, <=10 tries), center.
Sprite transforms (`utils/transform.lua`): rescale (uniform factor,
ceil to pixels), rotate (+-angle), affine (random shear axis),
normalize max -> 1.

Images are HW numpy float arrays in [0, 1]; outputs HWC."""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np


# ---- sprite transforms (utils/transform.lua) ----


def rescale_sprite(sprite: np.ndarray, scale: Tuple[float, float], rng) -> np.ndarray:
    from PIL import Image

    lo, hi = min(scale), max(scale)
    s = int(math.ceil(rng.uniform(lo, hi) * sprite.shape[0]))
    s = max(s, 1)
    im = Image.fromarray(sprite.astype(np.float32), mode="F").resize((s, s), Image.BILINEAR)
    return np.asarray(im)


def rotate_sprite(sprite: np.ndarray, angle_deg: float, rng) -> np.ndarray:
    from PIL import Image

    theta = rng.uniform(-angle_deg, angle_deg)
    im = Image.fromarray(sprite.astype(np.float32), mode="F").rotate(
        theta, resample=Image.BILINEAR
    )
    return np.asarray(im)


def affine_sprite(sprite: np.ndarray, angle_deg: float, rng) -> np.ndarray:
    from PIL import Image

    theta = math.radians(rng.uniform(-angle_deg, angle_deg))
    t = math.tan(theta)
    diag = [t, 0.0] if rng.uniform() < 0.5 else [0.0, t]
    h, w = sprite.shape
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    a = np.array([[1.0, diag[0]], [diag[1], 1.0]])
    a_xy = np.array([[a[1, 1], a[1, 0]], [a[0, 1], a[0, 0]]])
    off = np.array([cx, cy]) - a_xy @ np.array([cx, cy])
    coeffs = (a_xy[0, 0], a_xy[0, 1], off[0], a_xy[1, 0], a_xy[1, 1], off[1])
    im = Image.fromarray(sprite.astype(np.float32), mode="F").transform(
        (w, h), Image.AFFINE, coeffs, resample=Image.BILINEAR
    )
    return np.asarray(im)


def normalize_sprite(sprite: np.ndarray) -> np.ndarray:
    m = sprite.max()
    return sprite / m if m > 0 else sprite


# ---- position samplers (utils/position.lua) ----


def sample_position(method: str, obs: np.ndarray, sprite: np.ndarray, border: int, rng):
    h, w = obs.shape[:2]
    sh, sw = sprite.shape[:2]
    lo_y, hi_y = border, h - sh - border
    lo_x, hi_x = border, w - sw - border
    if hi_y < lo_y or hi_x < lo_x:
        return None, None

    if method == "uniform":
        return int(rng.integers(lo_y, hi_y + 1)), int(rng.integers(lo_x, hi_x + 1))
    if method == "split":
        def helper(small, large):
            quarter = int(math.ceil((large - small) / 8))
            ranges = [(small, small + quarter), (small + quarter, large - quarter),
                      (large - quarter, large)]
            a, b = ranges[int(rng.integers(0, 3))]
            return int(rng.integers(min(a, b), max(a, b) + 1))
        return helper(lo_y, hi_y), helper(lo_x, hi_x)
    if method == "center":
        cy = int(math.ceil((h - sh) / 2))
        cx = int(math.ceil((w - sw) / 2))
        if lo_y <= cy <= hi_y and lo_x <= cx <= hi_x:
            return cy, cx
        return None, None
    if method == "overlap_constraint":
        digit = sprite != 0
        area = digit.sum()
        for _ in range(10):
            y = int(rng.integers(lo_y, hi_y + 1))
            x = int(rng.integers(lo_x, hi_x + 1))
            patch = obs[y : y + sh, x : x + sw] != 0
            overlap = (patch & digit).sum()
            if area == 0 or overlap / area <= 0.3:
                return y, x
        return None, None
    raise ValueError(method)


def _place(canvas: np.ndarray, sprite: np.ndarray, y: int, x: int):
    sh, sw = sprite.shape[:2]
    sub = canvas[y : y + sh, x : x + sw]
    np.clip(sub + sprite, 0.0, 1.0, out=sub)


@dataclass
class ClutterConfig:
    """`mnist_cluttered.lua:74-97` defaults."""

    megapatch_w: int = 28
    border: int = 0
    n_digits: float = 1
    n_classes: int = 10
    threshold: float = 0.1
    scale: Tuple[float, float] = (0.9, 1.1)
    angle: float = 0.0
    affine_angle: float = 0.0
    seed: int = 100
    task: str = "segmentation"


class ClutterGenerator:
    """createData equivalent: feeds digits in shuffled order
    (`task.lua:62-70`) and emits (observation HWC, target HWC) pairs."""

    def __init__(self, digits: np.ndarray, labels: np.ndarray, config: ClutterConfig):
        assert digits.ndim == 3  # (N, H, W) in [0, 1]
        m = digits.max()
        self.digits = digits.astype(np.float32) / (m if m > 0 else 1.0)
        self.labels = np.asarray(labels, np.int64)
        assert self.labels.min() >= 0 and self.labels.max() < config.n_classes
        self.cfg = config
        self.rng = np.random.default_rng(config.seed)
        self._perm = np.arange(len(digits))
        self._step = len(digits)  # force reshuffle on first use

    def _next_digit(self):
        self._step += 1
        if self._step >= len(self.digits):
            self._perm = self.rng.permutation(len(self.digits))
            self._step = 0
        i = self._perm[self._step]
        return self.digits[i], int(self.labels[i])

    def next_example(self) -> Tuple[np.ndarray, np.ndarray]:
        cfg, rng = self.cfg, self.rng
        w = cfg.megapatch_w
        obs = np.zeros((w, w), np.float32)

        if cfg.task == "segmentation":
            target = np.zeros((w, w, cfg.n_classes), np.float32)
            n = int(math.ceil(rng.normal(cfg.n_digits, 0.5)))
            for _ in range(max(n, 0)):
                sprite, cls = self._next_digit()
                if cfg.angle != 0:
                    sprite = rotate_sprite(sprite, cfg.angle, rng)
                for attempt in range(20):
                    rs = normalize_sprite(rescale_sprite(sprite, cfg.scale, rng))
                    y, x = sample_position("overlap_constraint", obs, rs, cfg.border, rng)
                    if y is not None:
                        break
                else:
                    # saturated canvas: give up on the overlap constraint
                    # like the reference's bounded retries (`utils/
                    # position.lua:overlap_constraint` stops at 10 tries)
                    # instead of looping forever
                    y, x = sample_position("uniform", obs, rs, cfg.border, rng)
                if y is None:  # sprite larger than the canvas: skip it
                    continue
                _place(obs, rs, y, x)
                _place(target[:, :, cls], rs, y, x)
            target = (target >= cfg.threshold).astype(np.float32)
            return obs[:, :, None], target

        if cfg.task in ("spatial_transform", "centered_transform"):
            target = np.zeros((w, w), np.float32)
            method = "uniform" if cfg.task == "spatial_transform" else "center"
            for _ in range(int(cfg.n_digits)):
                sprite, _cls = self._next_digit()
                ground_truth = sprite.copy()
                if cfg.angle != 0:
                    sprite = rotate_sprite(sprite, cfg.angle, rng)
                if cfg.affine_angle != 0:
                    sprite = affine_sprite(sprite, cfg.affine_angle, rng)
                for attempt in range(20):
                    rs = normalize_sprite(rescale_sprite(sprite, cfg.scale, rng))
                    y, x = sample_position(method, obs, rs, cfg.border, rng)
                    if y is not None:
                        break
                else:
                    raise ValueError(
                        f"sprite cannot be placed on a {w}px canvas with "
                        f"border {cfg.border} and scale {cfg.scale}"
                    )
                _place(obs, rs, y, x)
                gy, gx = sample_position("center", target, ground_truth, cfg.border, rng)
                if gy is None:
                    raise ValueError(
                        f"centered target cannot fit: canvas {w}px, "
                        f"border {cfg.border}, digit {ground_truth.shape}"
                    )
                _place(target, ground_truth, gy, gx)
            target = (target >= cfg.threshold).astype(np.float32)
            return obs[:, :, None], target[:, :, None]

        raise ValueError(f"unknown task {cfg.task}")

    def generate(self, n: int):
        xs, ys = [], []
        for _ in range(n):
            o, t = self.next_example()
            xs.append(o)
            ys.append(t)
        return np.stack(xs), np.stack(ys)


# Generator-script configs (`segmentation.lua`, `spatial_transform.lua`,
# `rotation.lua` / `scaling.lua` / `translation.lua` /
# `affine_transform.lua` — diff-verified single-factor variants).
TASK_CONFIGS = {
    "segmentation": dict(task="segmentation", megapatch_w=64, n_digits=5, border=0,
                         scale=(0.5, 1.25), angle=60, seed=1, threshold=0.3),
    "spatial_transform": dict(task="spatial_transform", megapatch_w=64, n_digits=1,
                              border=0, scale=(0.5, 1.5), angle=60, affine_angle=60,
                              seed=1, threshold=0.3),
    "rotation": dict(task="spatial_transform", megapatch_w=64, n_digits=1, border=0,
                     scale=(1.0, 1.0), angle=60, affine_angle=0, seed=1, threshold=0.3),
    "scaling": dict(task="spatial_transform", megapatch_w=64, n_digits=1, border=0,
                    scale=(0.5, 1.5), angle=0, affine_angle=0, seed=1, threshold=0.3),
    "translation": dict(task="spatial_transform", megapatch_w=64, n_digits=1, border=0,
                        scale=(1.0, 1.0), angle=0, affine_angle=0, seed=1, threshold=0.3),
    "affine": dict(task="spatial_transform", megapatch_w=64, n_digits=1, border=0,
                   scale=(1.0, 1.0), angle=0, affine_angle=60, seed=1, threshold=0.3),
    "translation_3": dict(task="spatial_transform", megapatch_w=64, n_digits=3, border=0,
                          scale=(1.0, 1.0), angle=0, affine_angle=0, seed=1, threshold=0.3),
    "reconstruction": dict(task="centered_transform", megapatch_w=64, n_digits=1, border=0,
                           scale=(1.0, 1.0), angle=0, affine_angle=0, seed=1, threshold=0.3),
}


def synthetic_digits(n: int = 200, seed: int = 3, size: int = 28):
    """Fake digit sprites (blurred class-coded blobs) for running the
    full pipeline without the real MNIST files (zero-egress testing)."""
    rng = np.random.default_rng(seed)
    digits = np.zeros((n, size, size), np.float32)
    labels = np.arange(n) % 10
    yy, xx = np.mgrid[0:size, 0:size]
    for i in range(n):
        c = labels[i]
        k = c + 2
        cx = size / 2 + rng.normal(0, 2)
        cy = size / 2 + rng.normal(0, 2)
        pattern = np.sin(k * np.arctan2(yy - cy, xx - cx)) ** 2
        r = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2)
        ring = np.exp(-((r - (4 + c * 0.7)) ** 2) / 8.0)
        digits[i] = np.clip(pattern * ring + 0.1 * rng.random((size, size)), 0, 1)
        digits[i][digits[i] < 0.25] = 0
    return digits, labels.astype(np.int64)
