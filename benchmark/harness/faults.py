"""Faults planted under the timed path, for the tests that see `correct`
come out false and for the readings that set the limits. Each is a
context manager that patches the program while it is active; the harness
builds the program inside it.

  unchanged      the step returns its state unchanged
  half           gravity from every other body only, times 2 (half of the
                 sources left out, the mean taken over the rest)
  altered        one body's position, picked from the seed, moved by 1% of
                 its distance from the origin after every step
  no_collisions  the collision pass returns its state unchanged
  outliers       the tree's exact launch for its outliers (the bodies
                 farthest from the centre, outliers <- all) returns zeros
  deep_rows      the deep chain's rows lose their inner near field (the
                 smoothed aggregates of the cells about them return zeros)
  tiles          the hot-zone tiles' refined rows lose their near field
  no_block       the block collision pass's dense stage (the blocks
                 against their windows) returns no corrections
  no_residual    the block pass's exact residual (the bodies its blocks
                 could not cover) is skipped

`applies(name, resolved)` says whether a run's resolved configuration
runs the path that a fault breaks.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def patched(module, name, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def _unchanged():
    from nbodysim_tpu_torch import api

    return patched(api, "make_step", lambda config, *a, **k: (lambda s: s))


def _half():
    from nbodysim_tpu_torch.physics import integrators

    real = integrators.compute_accelerations

    def half(pos, mass, config):
        keep = torch.zeros_like(mass)
        keep[::2] = 2.0
        return real(pos, mass * keep, config)

    return patched(integrators, "compute_accelerations", half)


def _altered(seed: int):
    from nbodysim_tpu_torch import api

    real = api.make_step

    def make_step(config, *a, **k):
        step = real(config, *a, **k)

        def altered(s):
            out = step(s)
            b = seed % out.n
            pos = out.pos.clone()
            pos[b] = pos[b] * 1.01 + 1.0
            return out.replace(pos=pos)

        return altered

    return patched(api, "make_step", make_step)


def _no_collisions():
    from nbodysim_tpu_torch.physics import collisions

    return patched(collisions, "resolve_collisions", lambda s, c: s)


def _outliers():
    from nbodysim_tpu_torch.physics import barneshut

    real = barneshut._exact_couplings

    def couplings(*a, **k):
        ext, acc_heavy, acc_out, acc_from_out = real(*a, **k)
        return ext, acc_heavy, torch.zeros_like(acc_out), acc_from_out

    return patched(barneshut, "_exact_couplings", couplings)


def _deep_rows():
    from nbodysim_tpu_torch.physics import barneshut

    real = barneshut._deep_near_aggregates
    return patched(barneshut, "_deep_near_aggregates",
                    lambda *a, **k: torch.zeros_like(real(*a, **k)))


def _tiles():
    from nbodysim_tpu_torch.physics import barneshut

    real = barneshut._tile_refine

    def refine(*a, **k):
        refined, far_ref, near_ref = real(*a, **k)
        return refined, far_ref, torch.zeros_like(near_ref)

    return patched(barneshut, "_tile_refine", refine)


def _no_block():
    from nbodysim_tpu_torch.physics import collisions

    real = collisions._block_dense_deltas

    def dense(*a, **k):
        dp, dv = real(*a, **k)
        return torch.zeros_like(dp), torch.zeros_like(dv)

    return patched(collisions, "_block_dense_deltas", dense)


def _no_residual():
    from nbodysim_tpu_torch.physics import collisions

    return patched(collisions, "_residual_corrections",
                    lambda dpos_s, dvel_s, *a, **k: (dpos_s, dvel_s))


def plant(name: str, seed: int):
    if name == "altered":
        return _altered(seed)
    return {"unchanged": _unchanged, "half": _half,
            "no_collisions": _no_collisions, "outliers": _outliers,
            "deep_rows": _deep_rows, "tiles": _tiles, "no_block": _no_block,
            "no_residual": _no_residual}[name]()


def applies(name: str, resolved: dict) -> bool:
    """Whether a run whose resolved configuration is `resolved` (the
    harness's `cli.resolved`) runs what `name` breaks."""
    if name == "outliers":
        return resolved["force_backend"] == "bh"
    if name in ("deep_rows", "tiles"):
        deep = resolved.get("deep_levels", 0) > resolved.get("levels", 0)
        return deep and (name == "deep_rows" or resolved["tiles"][0] > 0)
    if name == "no_collisions":
        return resolved["enable_collisions"]
    if name in ("no_block", "no_residual"):
        return resolved["collision_pass"] == "block"
    return True


NAMES = ("unchanged", "half", "altered", "no_collisions", "outliers",
         "deep_rows", "tiles", "no_block", "no_residual")
