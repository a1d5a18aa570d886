"""On-device point-splat renderer (port of `nbodysim_tpu.render.splat`).

The reference renders with raylib (main.cpp:726-841): each body a circle
sprite tinted by a 10-bucket mass -> star-class color table
(getStarColorWithBrightness, main.cpp:549-610), the largest body a
black-hole composite (drawBlackHole, main.cpp:477-547), and performance
mode plain white circles (main.cpp:745-790).

Here the framebuffer is built on the state's device from bilinear point
splats, scatter-added with `index_put_(..., accumulate=True)` (XLA's
scatter-add in the JAX package, outside any Pallas kernel), and the
black-hole composite is a closed-form function of the pixel coordinates;
only the final uint8 image leaves the device. Camera semantics match
worldToScreen (main.cpp:196-201): screen = (world - center) * scale +
(W/2, H/2).

Float -> int casts of off-screen bodies are clamped to just outside the
frame first (XLA saturates out-of-range casts; torch leaves them
undefined): every on-screen pixel is the same either way. On a card the
scatter-add accumulates atomically, so after the truncating uint8 cast a
pixel may differ by 1 between runs and from the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from nbodysim_tpu_torch.config import SimConfig
from nbodysim_tpu_torch.core.state import ParticleState

# Mass -> star-class color table (main.cpp:555-580): upper thresholds and
# RGB; masses above the last threshold get the near-invisible class.
STAR_THRESHOLDS = (0.08, 0.4, 0.8, 1.2, 1.5, 2.5, 5.0, 15.0, 25.0, 50.0)
STAR_COLORS = (
    (0, 0, 255),       # deep blue (hyper-giant blue)
    (100, 100, 255),   # blue
    (173, 216, 230),   # light blue (blue-white)
    (219, 233, 244),   # bluish white
    (255, 255, 200),   # light yellow
    (255, 240, 150),   # yellow (sun-like)
    (255, 150, 50),    # light orange
    (255, 100, 0),     # deep orange (orange dwarf)
    (255, 50, 0),      # orange red (red dwarf)
    (200, 0, 0),       # deep red (brown dwarf)
)
STAR_COLOR_DEFAULT = (0, 0, 2)  # "neutron star" fallback (main.cpp:577)


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    width: int = 1200          # reference window (main.cpp:639-640)
    height: int = 900
    scale: float = 1.0
    center: tuple = (0.0, 0.0)
    brightness: float = 3.0    # main.cpp:830
    performance_mode: bool = False   # white splats (main.cpp:745-790)
    draw_black_hole: bool = True
    exposure: float = 1.0      # tone-map divisor on accumulated light
    show_quadtree: bool = False      # Q toggle (main.cpp:678-681)
    show_connections: bool = False   # C toggle (main.cpp:682-685)

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


def _f32(values, device) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.float32, device=device)


def star_colors(mass: torch.Tensor, brightness: float = 1.0) -> torch.Tensor:
    """Per-body RGB [N, 3] in [0, 255] floats from the reference table."""
    thresholds = _f32(STAR_THRESHOLDS, mass.device)
    table = _f32(STAR_COLORS + (STAR_COLOR_DEFAULT,), mass.device)
    # First bucket whose threshold exceeds the mass; masses beyond all
    # thresholds hit the fallback row.
    idx = torch.searchsorted(thresholds, mass.contiguous(), right=True)
    return torch.clamp(table[idx] * brightness, 0.0, 255.0)


def _world_to_screen(pos, scale, center, width, height):
    """main.cpp:196-201 semantics (y down, origin at screen center)."""
    return (pos - center) * scale + _f32([width / 2.0, height / 2.0],
                                         pos.device)


def _pixel_index(coord: torch.Tensor, size: int) -> torch.Tensor:
    """An integral float pixel coordinate as int64, clamped to [-1, size]
    first (off-screen stays off-screen; the cast never overflows)."""
    return torch.clamp(coord, -1.0, float(size)).to(torch.int64)


# drawBlackHole constants (main.cpp:477-547).
_BH_SEGMENTS = 5048            # main.cpp:495
_BH_QUAD_ALPHA = 2.0 / 255.0   # per-quad disk alpha (main.cpp:523)
# Glow layers i = 4..0 (back to front): radius multiplier 1 + 1.4*i, centre
# alpha (1 - i/4)*1.1 cast to an unsigned byte as the reference compiles it
# (the i=0 layer's 280.5 wraps to 24/255).
_BH_GLOW_LAYERS = tuple(
    (1.0 + 1.4 * i, (int((1.0 - i / 4.0) * 1.1 * 255.0) % 256) / 255.0)
    for i in (4, 3, 2, 1, 0)
)


def _black_hole_layer(
    frame: torch.Tensor,        # [H, W, 3] float
    screen_pos: torch.Tensor,   # [2]
    screen_radius: torch.Tensor,
    width: int,
    height: int,
) -> torch.Tensor:
    """Closed-form black-hole composite (drawBlackHole, main.cpp:477-547;
    the derivation is in the JAX module): five glow gradients, the
    accretion disk's angular opacity ramp between 2.1R and 10.51R with its
    tan(12 theta) y-warp, the event horizon, and the photon ring at R."""
    device = frame.device
    ys = torch.arange(height, dtype=torch.float32, device=device)[:, None]
    xs = torch.arange(width, dtype=torch.float32, device=device)[None, :]
    dx = xs - screen_pos[0]
    dy = ys - screen_pos[1]
    r = torch.sqrt(dx * dx + dy * dy)
    R = torch.clamp_min(screen_radius, 1e-3)
    theta = torch.atan2(dy, dx)

    # 1) layered glow gradients (back-to-front)
    glow_color = _f32([255.0, 255.0, 237.0], device)
    for mult, a in _BH_GLOW_LAYERS:
        rad = R * mult
        fade = (torch.clamp(1.0 - r / rad, 0.0, 1.0) * a)[..., None]
        frame = frame * (1.0 - fade) + glow_color * fade

    # 2) accretion disk (tan spikes clipped to keep the warp finite)
    distortion = 0.55 + 0.10 * (1.02 - torch.tan(theta * 12.0))
    distortion = torch.clamp(distortion, 0.05, 2.5)
    r_ell = torch.sqrt(dx * dx + (dy / distortion) ** 2)
    r_n = r_ell / R
    in_disk = (r_n >= 2.1) & (r_n <= 10.51)

    deg = torch.rad2deg(theta) % 360.0
    s = float(_BH_SEGMENTS)
    k_main = s * deg * (1.0 / 300.0 - 1.0 / 390.0)
    k_wrap = torch.clamp_min(s * (1.0 - (deg + 360.0) / 390.0), 0.0)
    k = torch.where(deg <= 300.0, k_main, s * (1.0 - deg / 390.0)) + k_wrap
    opacity = torch.where(
        in_disk, 1.0 - torch.pow(1.0 - _BH_QUAD_ALPHA, k), 0.0)[..., None]

    b = 1.4 + (10.5 + torch.cos(theta))
    disk_rgb = torch.stack([3.0 * b, 2.0 * b, 6.0 * b], dim=-1)
    frame = frame * (1.0 - opacity) + disk_rgb * opacity

    # 3) event horizon
    grad = torch.clamp(1.0 - r / (1.03 * R), 0.0, 1.0)[..., None]
    horizon_rgb = grad * _f32([0.0, 0.0, 40.0], device)
    frame = torch.where((r < 1.03 * R)[..., None], horizon_rgb, frame)
    frame = torch.where((r < R)[..., None], 0.0, frame)

    # 4) photon ring
    half_t = 0.011 * R / 2.0
    on_ring = (torch.abs(r - R) <= torch.clamp_min(half_t, 0.5))[..., None]
    return torch.where(on_ring, _f32([255.0, 225.0, 210.0], device), frame)


def render_frame(
    state: ParticleState,
    render: Optional[RenderConfig] = None,
    config: Optional[SimConfig] = None,
) -> torch.Tensor:
    """Rasterize a state to a uint8 RGB image [H, W, 3] on its device."""
    rc = render or RenderConfig()
    w, h = rc.width, rc.height
    device = state.device
    center = _f32(rc.center, device)

    pos2 = state.pos[:, :2]
    sp = _world_to_screen(pos2, rc.scale, center, w, h)
    if rc.performance_mode:
        rgb = torch.full((state.n, 3), 255.0, device=device)
    else:
        rgb = star_colors(state.mass, rc.brightness)

    # Bigger bodies deposit more light: weight by on-screen size (clamped),
    # the splat analogue of the sprite's screenRadius (main.cpp:815).
    screen_radius = torch.clamp_min(state.radius * rc.scale, 1.0)
    weight = torch.clamp(screen_radius, 1.0, 4.0)[:, None]

    # Bilinear scatter-add into the framebuffer (anti-aliased point splat).
    x, y = sp[:, 0], sp[:, 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = (x - x0)[:, None], (y - y0)[:, None]
    frame = torch.zeros((h, w, 3), dtype=torch.float32, device=device)
    for ddx, ddy, wgt in (
        (0, 0, lambda: (1 - fx) * (1 - fy)),
        (1, 0, lambda: fx * (1 - fy)),
        (0, 1, lambda: (1 - fx) * fy),
        (1, 1, lambda: fx * fy),
    ):
        xi = _pixel_index(x0 + ddx, w)
        yi = _pixel_index(y0 + ddy, h)
        inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        contrib = rgb * wgt() * weight * inside[:, None]
        frame.index_put_((torch.clamp(yi, 0, h - 1),
                          torch.clamp(xi, 0, w - 1)), contrib,
                         accumulate=True)
    frame = frame / rc.exposure

    if rc.draw_black_hole and not rc.performance_mode:
        # The largest-radius body is the black hole (main.cpp:794-804).
        c = torch.argmax(state.radius)
        bh_screen = _world_to_screen(pos2[c], rc.scale, center, w, h)
        bh_radius = torch.clamp_min(state.radius[c] * rc.scale, 2.0)
        frame = _black_hole_layer(frame, bh_screen, bh_radius, w, h)

    frame = torch.clamp(frame, 0.0, 255.0).to(torch.uint8)

    if rc.show_connections:
        from nbodysim_tpu_torch.render.overlays import connections_overlay

        frame = connections_overlay(frame, state, rc.scale, rc.center)
    if rc.show_quadtree:
        from nbodysim_tpu_torch.render.overlays import quadtree_overlay

        frame = quadtree_overlay(frame, state, rc.scale, rc.center)
    return frame
