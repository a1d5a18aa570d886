#!/usr/bin/env python3
"""Hold the tree forces of one checkout to another's bit for bit, on the CPU.

    python scripts/torch_tree_bitcheck.py PARENT CHANGE

Each ROOT is a directory holding `nbodysim_tpu_torch/`; each runs in a
process of its own. Both evaluate the same 50 cases at N = 2048-4096
through `compute_accelerations` (`force_backend="bh"`, deterministic CPU
`index_add_`):
  * 2D, a clustered scene, R = 2 and 3: the plain quadtree (the overflow
    residual), the deep chain without tiles, with tiles at the default caps,
    and with the deep rows', tile scatter's and tile apply's caps cut to
    9n/10 (the compaction fits) and to 16 (it falls back to every row),
    one at a time and all three at once;
  * 3D, `scenes/blob.clustered_blob`, R = 2 and 3: the plain octree, the
    deep chain with `bh_nf_sparse` 0 and 1, at R = 2 with tiles and the same
    cap cuts (the octree's caps), and with the sparse near field's source
    cap fitting and falling back and its target cap cut (promotion);
  * 3D, a lattice with no overflowing cell (the deep chain's early return).
Each case's accelerations, span names in order and counters (host reads,
row counts) must be equal. Takes ~30 s a checkout. Exit status 1 on any
difference.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import warnings
from pathlib import Path

import numpy as np


def _scene2(n, seed=3):
    rng = np.random.default_rng(seed)
    pos = np.concatenate([
        60 * rng.standard_normal((n // 4, 2)) + [1500, -700],
        40 * rng.standard_normal((n // 4, 2)) + [-2000, 1000],
        rng.uniform(-4000, 4000, (n - n // 2, 2))]).astype(np.float32)
    return pos, rng.uniform(0.1, 10.0, n).astype(np.float32)


def _cases(bh, bh3):
    """[(name, scene key, config fields, {(module, cap name): cap})]."""
    fits = lambda n: (9 * n) // 10         # noqa: E731
    falls = lambda n: 16                    # noqa: E731
    caps2 = ("_deep_rows_cap", "_scatter_cap", "_refined_cap")
    caps3 = ("_deep_rows_cap3", "_scatter_cap3", "_refined_cap3")
    out = []

    def cap_cuts(name, scene, cfg, mod, caps):
        for tag, fn in (("fits", fits), ("falls", falls)):
            out.append((f"{name}-all-{tag}", scene, cfg,
                        {(mod, c): fn for c in caps}))
            for c in caps:
                out.append((f"{name}-{c}-{tag}", scene, cfg, {(mod, c): fn}))

    for r in (2, 3):
        base = dict(n=2048, force_backend="bh", bh_levels=4,
                    bh_accept_radius=r, enable_collisions=False)
        deep = {**base, "bh_deep_levels": 6, "bh_tile_levels": 0}
        tiles = {**deep, "bh_tile_levels": 2, "bh_tile_size": 8,
                 "bh_tile_count": 4}
        out += [(f"2d-plain-R{r}", "2d", base, {}),
                (f"2d-deep-R{r}", "2d", deep, {}),
                (f"2d-tiles-R{r}", "2d", tiles, {})]
        cap_cuts(f"2d-tiles-R{r}", "2d", tiles, bh, caps2)
    for r in (2, 3):
        base = dict(n=2048, dim=3, force_backend="bh", bh_levels=3,
                    bh_accept_radius=r, enable_collisions=False)
        out.append((f"3d-plain-R{r}", "3d", base, {}))
        for sp in (0, 1):
            deep = {**base, "bh_deep_levels": 5, "bh_tile_levels": 0,
                    "bh_nf_sparse": sp}
            out.append((f"3d-deep-R{r}-sp{sp}", "3d", deep, {}))
            if r == 3:
                continue        # tiles at R = 3 need t >= 6: a slow case
            tiles = {**deep, "bh_tile_levels": 2, "bh_tile_size": 4,
                     "bh_tile_count": 4}
            name = f"3d-tiles-R{r}-sp{sp}"
            out.append((name, "3d", tiles, {}))
            cap_cuts(name, "3d", tiles, bh3, caps3)
            if sp:
                for tag, fn in (("fits", lambda n: n // 2), ("falls", falls)):
                    out.append((f"{name}-srccap-{tag}", "3d", tiles,
                                {(bh3, "_nf_sparse_src_cap"): fn}))
                out.append((f"{name}-tgtcap", "3d", tiles,
                            {(bh3, "_nf_sparse_cap"): lambda n: 100}))
    out.append(("3d-lattice-deep", "lattice", dict(
        n=4096, dim=3, force_backend="bh", bh_levels=3, bh_deep_levels=5,
        bh_tile_levels=2, bh_tile_size=4, bh_tile_count=4,
        enable_collisions=False), {}))
    return out


def run(root: str, out: str) -> None:
    """Evaluate every case with the package under `root`; write `out`.npz
    (accelerations) and `out`.json (spans and counters)."""
    sys.path.insert(0, root)
    import torch

    import nbodysim_tpu_torch as nt
    from nbodysim_tpu_torch.diagnostics import profiling
    from nbodysim_tpu_torch.physics import barneshut as bh
    from nbodysim_tpu_torch.physics import barneshut3d as bh3
    from nbodysim_tpu_torch.scenes.blob import clustered_blob

    assert Path(nt.__file__).is_relative_to(Path(root).resolve()), nt.__file__
    side = 16
    lat = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"), -1)
    scenes = {
        "2d": tuple(map(torch.from_numpy, _scene2(2048))),
        "3d": clustered_blob(2048, center=(500, -300, 200), span=2000,
                             seed=3, device="cpu"),
        "lattice": (torch.from_numpy((lat.reshape(-1, 3) * 100.0)
                                     .astype(np.float32)),
                    torch.ones(side ** 3)),
    }
    accs, meta = {}, {}
    for name, scene, cfg, patches in _cases(bh, bh3):
        saved = {k: getattr(*k) for k in patches}
        for (mod, attr), fn in patches.items():
            setattr(mod, attr, fn)
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                with profiling.recording() as rec:
                    acc = nt.compute_accelerations(*scenes[scene],
                                                   nt.SimConfig(**cfg))
        finally:
            for (mod, attr), fn in saved.items():
                setattr(mod, attr, fn)
        accs[name] = acc.numpy()
        meta[name] = dict(spans=[s.name for s in rec.spans],
                          counters=rec.counters)
    np.savez(out + ".npz", **accs)
    Path(out + ".json").write_text(json.dumps(meta, sort_keys=True))


def main(argv) -> int:
    if argv[:1] == ["--run"]:
        run(argv[1], argv[2])
        return 0
    a_root, b_root = argv
    with tempfile.TemporaryDirectory() as tmp:
        outs = []
        for i, root in enumerate((a_root, b_root)):
            out = f"{tmp}/{i}"
            subprocess.run([sys.executable, __file__, "--run",
                            str(Path(root).resolve()), out], check=True)
            outs.append((np.load(out + ".npz"),
                         json.loads(Path(out + ".json").read_text())))
        (a, ma), (b, mb) = outs
        assert sorted(a.files) == sorted(b.files)
        bad = [k for k in a.files
               if not np.array_equal(a[k], b[k]) or ma[k] != mb[k]]
        print(f"{len(a.files)} cases; accelerations, spans and counters "
              f"differ in {len(bad)}: {bad}")
        return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
