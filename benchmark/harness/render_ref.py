"""Plain reference of the viewer's framebuffer: the reference program's
renderer (main.cpp:196-201, 477-610, 726-841) as a bilinear point splat, in
plain PyTorch and float32, the precision the configuration states. Frozen
from the program's renderer as it was when the benchmark was written, so
that an edit there cannot move the yardstick; it imports nothing of the
program.

  * each body splats its star-class colour (the 10-bucket mass table) times
    the brightness and its on-screen size clamped to [1, 4], bilinearly,
    into a float framebuffer, which is divided by the exposure;
  * the largest body is drawn as the black-hole composite: five glow
    layers, the accretion disk's angular opacity ramp with its tan(12
    theta) warp, the event horizon and the photon ring;
  * the result is clamped to [0, 255] and truncated to uint8.
"""

from __future__ import annotations

import torch

STAR_THRESHOLDS = (0.08, 0.4, 0.8, 1.2, 1.5, 2.5, 5.0, 15.0, 25.0, 50.0)
STAR_COLORS = (
    (0, 0, 255), (100, 100, 255), (173, 216, 230), (219, 233, 244),
    (255, 255, 200), (255, 240, 150), (255, 150, 50), (255, 100, 0),
    (255, 50, 0), (200, 0, 0), (0, 0, 2))
SEGMENTS = 5048
QUAD_ALPHA = 2.0 / 255.0
GLOW = tuple((1.0 + 1.4 * i, (int((1.0 - i / 4.0) * 1.1 * 255.0) % 256) / 255.0)
             for i in (4, 3, 2, 1, 0))


def _t(values, device, dtype):
    return torch.tensor(values, dtype=dtype, device=device)


def _black_hole(frame, sp, rad, width, height, dtype):
    dev = frame.device
    ys = torch.arange(height, dtype=dtype, device=dev)[:, None]
    xs = torch.arange(width, dtype=dtype, device=dev)[None, :]
    dx = xs - sp[0]
    dy = ys - sp[1]
    r = torch.sqrt(dx * dx + dy * dy)
    big_r = torch.clamp_min(rad, 1e-3)
    theta = torch.atan2(dy, dx)
    glow = _t([255.0, 255.0, 237.0], dev, dtype)
    for mult, a in GLOW:
        fade = (torch.clamp(1.0 - r / (big_r * mult), 0.0, 1.0) * a)[..., None]
        frame = frame * (1.0 - fade) + glow * fade
    warp = torch.clamp(0.55 + 0.10 * (1.02 - torch.tan(theta * 12.0)),
                       0.05, 2.5)
    r_n = torch.sqrt(dx * dx + (dy / warp) ** 2) / big_r
    in_disk = (r_n >= 2.1) & (r_n <= 10.51)
    deg = torch.rad2deg(theta) % 360.0
    s = float(SEGMENTS)
    k_wrap = torch.clamp_min(s * (1.0 - (deg + 360.0) / 390.0), 0.0)
    k = torch.where(deg <= 300.0, s * deg * (1.0 / 300.0 - 1.0 / 390.0),
                    s * (1.0 - deg / 390.0)) + k_wrap
    opacity = torch.where(in_disk, 1.0 - torch.pow(1.0 - QUAD_ALPHA, k),
                          0.0)[..., None]
    b = 1.4 + (10.5 + torch.cos(theta))
    frame = frame * (1.0 - opacity) + torch.stack(
        [3.0 * b, 2.0 * b, 6.0 * b], dim=-1) * opacity
    grad = torch.clamp(1.0 - r / (1.03 * big_r), 0.0, 1.0)[..., None]
    frame = torch.where((r < 1.03 * big_r)[..., None],
                        grad * _t([0.0, 0.0, 40.0], dev, dtype), frame)
    frame = torch.where((r < big_r)[..., None], 0.0, frame)
    ring = (torch.abs(r - big_r) <= torch.clamp_min(0.011 * big_r / 2.0, 0.5))
    return torch.where(ring[..., None], _t([255.0, 225.0, 210.0], dev, dtype),
                       frame)


def render(pos, mass, radius, width: int, height: int, scale: float,
           center=(0.0, 0.0), brightness: float = 3.0, exposure: float = 1.0,
           dtype=torch.float32) -> torch.Tensor:
    """uint8 [height, width, 3] framebuffer of the bodies, in `dtype`."""
    dev = pos.device
    pos = pos[:, :2].to(dtype)
    c = _t(center, dev, dtype)
    half = _t([width / 2.0, height / 2.0], dev, dtype)
    sp = (pos - c) * scale + half
    idx = torch.searchsorted(_t(STAR_THRESHOLDS, dev, torch.float32),
                             mass.float().contiguous(), right=True)
    rgb = torch.clamp(_t(STAR_COLORS, dev, dtype)[idx] * brightness,
                      0.0, 255.0)
    weight = torch.clamp(torch.clamp_min(radius.to(dtype) * scale, 1.0),
                         1.0, 4.0)[:, None]
    x, y = sp[:, 0], sp[:, 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = (x - x0)[:, None], (y - y0)[:, None]
    frame = torch.zeros((height, width, 3), dtype=dtype, device=dev)
    for ox, oy, w in ((0, 0, (1 - fx) * (1 - fy)), (1, 0, fx * (1 - fy)),
                      (0, 1, (1 - fx) * fy), (1, 1, fx * fy)):
        xi = torch.clamp(x0 + ox, -1.0, float(width)).long()
        yi = torch.clamp(y0 + oy, -1.0, float(height)).long()
        inside = (xi >= 0) & (xi < width) & (yi >= 0) & (yi < height)
        frame.index_put_((yi[inside], xi[inside]),
                         (rgb * w * weight)[inside], accumulate=True)
    frame = frame / exposure
    big = torch.argmax(radius)
    bh_sp = (pos[big] - c) * scale + half
    bh_rad = torch.clamp_min(radius[big].to(dtype) * scale, 2.0)
    frame = _black_hole(frame, bh_sp, bh_rad, width, height, dtype)
    return torch.clamp(frame, 0.0, 255.0).to(torch.uint8)
