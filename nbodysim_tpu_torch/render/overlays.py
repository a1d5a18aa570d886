"""Debug overlays: quadtree wireframe and neighbour connections (port of
`nbodysim_tpu.render.overlays`).

Reference: the Q toggle draws occupied quadtree cell boundaries
(drawQuadtreeNode, main.cpp:394-475, gray 100/100/100 at ~40% alpha) and
the C toggle draws red lines to up to MAX_CONNECTIONS nearby bodies with
distance-based alpha (drawConnections, main.cpp:233-386).

Both work on the framebuffer, on the state's device:
  * quadtree overlay — pixels near an occupied pyramid-cell boundary are
    blended gray; occupancy comes from the mass pyramid the tree code builds
    (`physics/barneshut._build_pyramid`);
  * connections overlay — neighbour pairs from a sorted cell hash (fixed
    window), each segment splatted as T points with alpha falling off with
    distance (main.cpp:362); far out, cluster segments between occupied
    cells instead.
Pixel coordinates are clamped before their int cast, as in `splat.py`.
"""

from __future__ import annotations

import numpy as np
import torch

from nbodysim_tpu_torch.core.state import ParticleState
from nbodysim_tpu_torch.physics.collisions import (
    _cell_hash, _neighbour_offsets)

QUAD_COLOR = (100.0, 100.0, 100.0)
CONNECTION_COLOR = (255.0, 0.0, 0.0)   # main.cpp:364
CLUSTER_COLOR = (255.0, 190.0, 152.0)  # main.cpp:311
MAX_CONNECTIONS = 5                    # main.cpp:51


def _blend(frame: torch.Tensor, blend: torch.Tensor, color) -> torch.Tensor:
    """frame * (1 - blend) + color * blend, clipped, as uint8."""
    rgb = torch.tensor(color, dtype=torch.float32, device=frame.device)
    out = frame * (1 - blend) + rgb * blend
    return torch.clamp(out, 0, 255).to(torch.uint8)


def _round_pixel(coord: torch.Tensor, size: int) -> torch.Tensor:
    """round-half-even (jnp.round) of a float pixel coordinate as int64,
    clamped to [-1, size] first."""
    return torch.clamp(torch.round(coord), -1.0, float(size)).to(torch.int64)


def quadtree_overlay(
    frame: torch.Tensor,        # [H, W, 3] float or uint8
    state: ParticleState,
    scale: float,
    center,
    levels: int = 6,
    min_cell_px: float = 4.0,
    alpha: float = 0.4,
) -> torch.Tensor:
    """Blend occupied-cell boundaries of the mass pyramid into the frame."""
    from nbodysim_tpu_torch.physics.barneshut import _build_pyramid

    frame = frame.to(torch.float32)
    h, w = frame.shape[:2]
    device = frame.device
    grids, corner, size, _, _ = _build_pyramid(state.pos[:, :2], state.mass,
                                               levels)
    cx = torch.tensor(center, dtype=torch.float32, device=device)

    # Pixel -> world coordinates (inverse of worldToScreen, main.cpp:196).
    xs = (torch.arange(w, dtype=torch.float32, device=device)
          - w / 2.0) / scale + cx[0]
    ys = (torch.arange(h, dtype=torch.float32, device=device)
          - h / 2.0) / scale + cx[1]
    wx = xs[None, :].expand(h, w)
    wy = ys[:, None].expand(h, w)

    border = torch.zeros((h, w), dtype=torch.bool, device=device)
    for lv in range(1, levels + 1):
        res = 1 << lv
        s_l = size / res
        # Levels whose cells are under min_cell_px pixels draw nothing.
        big_enough = (s_l * scale) >= min_cell_px
        u = (wx - corner[0]) / s_l
        v = (wy - corner[1]) / s_l
        fu, fv = torch.floor(u), torch.floor(v)
        ci = torch.clamp(fu, 0, res - 1).to(torch.int64)
        cj = torch.clamp(fv, 0, res - 1).to(torch.int64)
        occ = grids[lv][0][ci, cj] > 0
        # Within ~1 px of a cell edge?
        fx, fy = u - fu, v - fv
        eps_px = 1.0 / torch.clamp_min(s_l * scale, 1e-6)
        on_edge = ((fx < eps_px) | (fx > 1 - eps_px)
                   | (fy < eps_px) | (fy > 1 - eps_px))
        inside = (u >= 0) & (u < res) & (v >= 0) & (v < res)
        border |= occ & on_edge & inside & big_enough
    return _blend(frame, alpha * border.to(torch.float32)[..., None],
                  QUAD_COLOR)


def connections_overlay(
    frame: torch.Tensor,
    state: ParticleState,
    scale: float,
    center,
    base_distance: float = 1000.0,   # MAX_DISTANCE, main.cpp:50
    base_connections: int = MAX_CONNECTIONS,
    segment_points: int = 16,
    cap: int = 8,
) -> torch.Tensor:
    """Splat neighbour-connection segments, zoom-adaptively (main.cpp:
    241-253): zoomFactor = max(0.1, scale), distance MAX_DISTANCE / zoom,
    connections MAX_CONNECTIONS / zoom, alpha max(50, 255 zoom) / 255,
    gridLevel max(0, -log2(zoom)). At gridLevel > 2 the connections
    collapse to salmon segments between neighbouring occupied cells
    (main.cpp:274-320, the reference's intended behaviour; SURVEY bug #5),
    otherwise per-body red lines."""
    zoom = max(0.1, float(scale))
    adaptive_distance = base_distance / zoom
    adaptive_connections = max(1, int(base_connections / zoom))
    adaptive_alpha = max(50.0, 255.0 * zoom) / 255.0
    grid_level = max(0, int(-np.log2(zoom)))
    if grid_level > 2:
        return _cluster_connections(
            frame, state, scale, center, adaptive_distance, adaptive_alpha,
            segment_points)
    return _body_connections(
        frame, state, scale, center, adaptive_distance,
        adaptive_connections, adaptive_alpha, segment_points, cap)


def _splat_points(acc: torch.Tensor, pts: torch.Tensor,
                  al: torch.Tensor) -> None:
    """Scatter-add alphas `al` [P] at rounded points `pts` [P, 2] into the
    [h, w] buffer `acc`; off-screen points add nothing."""
    h, w = acc.shape
    xi = _round_pixel(pts[:, 0], w)
    yi = _round_pixel(pts[:, 1], h)
    vis = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    acc.index_put_((torch.clamp(yi, 0, h - 1), torch.clamp(xi, 0, w - 1)),
                   torch.where(vis, al, 0.0), accumulate=True)


def _cluster_connections(frame, state, scale, center, cell_world,
                         alpha, segment_points):
    """Cluster-level mode: segments between neighbouring occupied-cell
    centres (mean body position per cell) on a dense screen-covering grid;
    constant adaptiveAlpha, salmon (main.cpp:296-316)."""
    frame = frame.to(torch.float32)
    h, w = frame.shape[:2]
    device = frame.device
    pos = state.pos[:, :2]
    cx = torch.tensor(center, dtype=torch.float32, device=device)

    # Dense cell grid over the visible world region (+1 cell margin).
    world_w, world_h = w / scale, h / scale
    g = int(np.clip(np.ceil(max(world_w, world_h) / cell_world) + 3, 4, 128))
    origin = cx - 0.5 * torch.tensor([world_w, world_h], dtype=torch.float32,
                                     device=device) - cell_world
    cf = torch.floor((pos - origin) / cell_world)
    inside = ((cf >= 0) & (cf < g)).all(-1)
    ci = torch.clamp(cf, 0, g - 1).to(torch.int64)
    flat = torch.where(inside, ci[:, 0] * g + ci[:, 1], g * g)

    def cell_sum(vals):   # scatter-add; flat = g*g (outside) is dropped
        out = torch.zeros(g * g + 1, dtype=torch.float32, device=device)
        out.index_add_(0, flat, vals)
        return out[:g * g]

    cnt = cell_sum(inside.to(torch.float32))
    sx = cell_sum(torch.where(inside, pos[:, 0], 0.0))
    sy = cell_sum(torch.where(inside, pos[:, 1], 0.0))
    safe = torch.clamp_min(cnt, 1.0)
    centers = torch.stack([sx / safe, sy / safe], -1).reshape(g, g, 2)
    occ = (cnt > 0).reshape(g, g)
    half = torch.tensor([w / 2.0, h / 2.0], dtype=torch.float32,
                        device=device)

    def to_screen(p):
        return (p - cx) * scale + half

    a = to_screen(centers).reshape(-1, 1, 2)
    t = torch.linspace(0.0, 1.0, segment_points, device=device)[None, :, None]
    ix = torch.arange(g, device=device)
    acc = torch.zeros((h, w), dtype=torch.float32, device=device)
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            if dx == 0 and dy == 0:
                continue
            nb_c = torch.roll(centers, (-dx, -dy), dims=(0, 1))
            nb_o = torch.roll(occ, (-dx, -dy), dims=(0, 1))
            # roll wraps; the wrapped edge rows are masked off
            edge_x = (ix + dx >= 0) & (ix + dx < g)
            edge_y = (ix + dy >= 0) & (ix + dy < g)
            ok = occ & nb_o & edge_x[:, None] & edge_y[None, :]
            b = to_screen(nb_c).reshape(-1, 1, 2)
            pts = (a * (1 - t) + b * t).reshape(-1, 2)
            al = torch.repeat_interleave(
                ok.reshape(-1).to(torch.float32) * alpha, segment_points)
            _splat_points(acc, pts, al)
    return _blend(frame, torch.clamp(acc, 0.0, 1.0)[..., None],
                  CLUSTER_COLOR)


def _body_connections(
    frame: torch.Tensor,
    state: ParticleState,
    scale: float,
    center,
    max_distance: float,
    max_connections: int,
    adaptive_alpha: float,
    segment_points: int = 16,
    cap: int = 8,
) -> torch.Tensor:
    """Per-body mode: red lines to up to `max_connections` in-range
    neighbours, alpha = (1 - d/adaptiveDistance) * adaptiveAlpha
    (main.cpp:364-367). Neighbours come from a hash-sorted grid of cells
    `max_distance` wide (main.cpp:74), scanning the first `cap` rows of each
    of the 3 x 3 neighbour cells' hash segments."""
    frame = frame.to(torch.float32)
    h, w = frame.shape[:2]
    device = frame.device
    pos = state.pos[:, :2]
    n = pos.shape[0]
    cx = torch.tensor(center, dtype=torch.float32, device=device)

    cell = torch.floor(pos / max_distance).to(torch.int32)
    n_buckets = 1 << max(1, (2 * n - 1).bit_length())
    hsh = _cell_hash(cell, n_buckets)
    order = torch.argsort(hsh, stable=True)
    h_s, pos_s, cell_s = hsh[order], pos[order], cell[order]

    nbr = cell_s[:, None, :] + _neighbour_offsets(2, device)[None]  # [N,9,2]
    nbr_h = _cell_hash(nbr, n_buckets)
    starts = torch.searchsorted(h_s, nbr_h.reshape(-1)).reshape(n, 9)
    win = torch.arange(cap, device=device)
    cand = (starts[:, :, None] + win).reshape(n, 9 * cap)
    in_range = cand < n
    cand_c = torch.clamp_max(cand, n - 1)
    # The actual cell must match too: hash-colliding neighbour offsets
    # would otherwise scan (and splat) the same segment twice.
    ok_hash = ((h_s[cand_c] == nbr_h.repeat_interleave(cap, dim=1))
               & (cell_s[cand_c] == nbr.repeat_interleave(cap, dim=1))
               .all(-1))
    self_i = torch.arange(n, device=device)[:, None]
    d = pos_s[cand_c] - pos_s[:, None, :]
    dist = torch.sqrt((d * d).sum(-1))
    valid = (in_range & ok_hash & (cand_c != self_i)
             & (dist < max_distance) & (dist > 0))

    # The first `max_connections` valid candidates of each body.
    rank = torch.cumsum(valid.to(torch.int32), dim=1)
    keep = valid & (rank <= max_connections)
    alpha = torch.where(keep, (1.0 - dist / max_distance) * adaptive_alpha,
                        0.0)                                    # [N, K]

    half = torch.tensor([w / 2.0, h / 2.0], dtype=torch.float32,
                        device=device)
    a = ((pos_s - cx) * scale + half)[:, None, None, :]        # [N,1,1,2]
    b = ((pos_s[cand_c] - cx) * scale + half)[:, :, None, :]   # [N,K,1,2]
    t = torch.linspace(0.0, 1.0, segment_points,
                       device=device)[None, None, :, None]
    pts = (a * (1 - t) + b * t).reshape(-1, 2)
    al = alpha[:, :, None].expand(-1, -1, segment_points).reshape(-1)
    acc = torch.zeros((h, w), dtype=torch.float32, device=device)
    _splat_points(acc, pts, al)
    return _blend(frame, torch.clamp(acc, 0.0, 1.0)[..., None],
                  CONNECTION_COLOR)
