"""The quadtree's M2L level — CUDA kernel, wrapper, plain version.

Replaces no TPU kernel: the JAX package leaves this contraction to XLA's
`conv_general_dilated` (`nbodysim_tpu/physics/barneshut.py:_m2l_conv`).
The kernel is `csrc/m2l2.cu`; its header says what bounds it on the H100
and how its design answers that.

One V-list level of the quadtree: the raw moment grids in, the 9 p=2 local
terms (F [2], J [3 sym], H [4 sym]) of every target cell out. The input is
g [..., X, r, 6], channel-last raw moments (m, m x, m y, m xx, m xy, m yy)
of a batch of grids (one `corner` [..., 2] each), X rows of which row 0 is
the grid's row `x0`; moments beyond the grid or the rows given are zero.
Targets are the `rows` rows from `row0` (both even; r even).

  * `m2l2` — the wrapper. On a CUDA tensor it launches the kernel (or
    raises); on a CPU tensor, and only there, it runs the plain version.
    `m2l2.launches` counts kernel launches, and each adds 1 to the tracing
    counter `m2l2.launches`. It takes the pyramid's channel-last grids as
    they lie (any strides: a channel view, a tile batch, a banded row
    window) and returns the 9 terms as views of one [9, ..., rows, r]
    buffer.
  * `m2l2_plain` — the same function in plain torch: the row window padded
    with zero rows to 2(R-1) halo rows a side, then
    `physics.barneshut._m2l_conv`, the parent-level convolution (cuDNN with
    TF32 off on a card; the reference the kernel is held to there, and the
    CPU path).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from nbodysim_tpu_torch.diagnostics import profiling

RADII = (2, 3, 4, 5)      # the acceptance radii csrc/m2l2.cu is built for


def m2l2_plain(g, corner, size, r_full: int, eps_sq, radius: int, *,
               row0: int, rows: int, x0: int):
    """The 9 local terms of the target rows [row0, row0 + rows) in plain
    torch (see module): `g`'s rows cut or zero-padded to the window of
    2(R-1) halo rows a side that `_m2l_conv` takes."""
    # Imported here: physics.barneshut imports this module.
    from nbodysim_tpu_torch.physics.barneshut import _m2l_conv

    qh = radius - 1
    lo, hi = row0 - 2 * qh - x0, row0 + rows + 2 * qh - x0
    n = g.shape[-3]
    if (lo, hi) != (0, n):
        g = F.pad(g[..., max(lo, 0):min(hi, n), :, :],
                  (0, 0, 0, 0, max(-lo, 0), max(hi - n, 0)))
    return _m2l_conv(g, corner, size, r_full, eps_sq, radius, row0=row0,
                     rows=rows)


def m2l2(g, corner, size, r_full: int, eps_sq, radius: int, *, row0: int,
         rows: int, x0: int):
    """One M2L level's 9 local terms, [..., rows, r_full] each (see
    module). CUDA tensor: the kernel; CPU: the plain version."""
    if g.device.type == "cpu":
        return m2l2_plain(g, corner, size, r_full, eps_sq, radius,
                          row0=row0, rows=rows, x0=x0)
    out = _launch(g, corner, size, r_full, eps_sq, radius, row0, rows, x0)
    m2l2.launches += 1
    profiling.count("m2l2.launches", 1)
    return tuple(out[t] for t in range(9))


m2l2.launches = 0


def _launch(g, corner, size, r_full, eps_sq, radius, row0, rows,
            x0) -> torch.Tensor:
    """One launch of csrc/m2l2.cu on CUDA tensors: [9, ..., rows, r].
    Counts nothing: the wrapper does."""
    if g.device.type != "cuda":
        raise ValueError(f"no M2L kernel for device {g.device}")
    from nbodysim_tpu_torch.kernels._build import check, library

    device = g.device
    for name, t in (("moments", g), ("corner", corner), ("size", size)):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.float32 \
                or t.device != device:
            raise ValueError(f"the M2L kernel takes float32 tensors on "
                             f"{device}; {name} is {type(t).__name__} "
                             f"{getattr(t, 'dtype', '')}")
    if g.dim() < 3 or g.shape[-2:] != (r_full, 6):
        raise ValueError(f"moments {tuple(g.shape)}: expected [..., X, "
                         f"{r_full}, 6], channel last")
    lead, X = g.shape[:-3], g.shape[-3]
    if r_full < 2 or r_full % 2 or row0 % 2 or rows % 2 or rows <= 0 \
            or row0 < 0 or row0 + rows > r_full:
        raise ValueError(f"the M2L kernel takes an even grid and even target "
                         f"rows inside it: r={r_full}, row0={row0}, "
                         f"rows={rows}")
    if radius not in RADII:
        raise ValueError(f"no M2L kernel for acceptance radius {radius}")
    if corner.shape[-1:] != (2,) or size.numel() != 1:
        raise ValueError(f"corner {tuple(corner.shape)} and size "
                         f"{tuple(size.shape)}: expected [..., 2] and one "
                         f"number")
    gb = g.reshape((-1,) + g.shape[-3:])
    batch = gb.shape[0]
    corner_b = corner.expand(lead + (2,)).reshape(batch, 2).contiguous()
    size_1 = size.reshape(1)
    out = torch.empty((9,) + lead + (rows, r_full), dtype=torch.float32,
                      device=device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        status = library().nb_m2l2(
            gb.data_ptr(), *gb.stride(), batch, X, x0, r_full, row0, rows,
            corner_b.data_ptr(), size_1.data_ptr(), float(eps_sq), radius,
            out.data_ptr(), stream)
    check(status, "nb_m2l2")
    return out
