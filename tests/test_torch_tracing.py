"""PyTorch port: the program's spans and counters
(`nbodysim_tpu_torch.diagnostics.profiling`: `span`, `host_read`, `count`,
`recording`).

On the CPU, for each tree (`TREES`: a 2D deep-chain merger step with the
block collision pass, a 3D Plummer-sphere step of the octree's deep
chain with its sparse near field, each at N = 2048 with its row
compactions forced on by smaller caps, and a step of the plain quadtree
with the bucket collision pass on the N = 2048 uniform square, whose
buckets overflow into the tree's residual): nothing is kept while nothing
records; the step gives bit-identical states with recording on and off;
its row counters equal counts taken from the compactions' own masks;
`host_syncs` equals the `host_read` calls, and the overflow counters
(`collide.overflow`, `tree.near_overflow`) the counts those reads return;
the spans nest step > forces > tree.* (each M2L level's `tree.m2l` inside
`tree.downward`, `tree.deep` and `tree.tiles`) and step > collisions >
collide.*; `trace()`'s Chrome trace holds them beside the aten ops; both
deep-chain trees' steps call the one pipeline's
`barneshut._exact_couplings` and `barneshut._tile_refine`.

On the card (marked `cuda`, skipped without one): over one step of a 2D
deep-chain merger, and of a 3D Plummer sphere whose buckets overflow (the
octree's deep chain, K7), `host_syncs` equals the syncs that
`torch.cuda.set_sync_debug_mode("warn")` reports less the uncounted
host-to-device copies of host constants, recording adds no sync, and the
states are bit-identical with recording on and off; each M2L level of the
merger step and of the Plummer step is one launch of its tree's M2L kernel,
with no cuDNN and no copy under `tree.m2l`; `Simulation.run(10)` on the N = 25,000 disc makes no host
sync; a viewer frame's `hud_text()` launches the potential kernel once and
syncs only in its two `host_read`s.
This file imports no JAX; on a machine with a card, run:

    python -m pytest --noconftest -q tests/test_torch_tracing.py
"""

import json
import linecache
import warnings
from collections import Counter
from pathlib import Path

import pytest
import torch

import nbodysim_tpu_torch as nt
from nbodysim_tpu_torch.app.viewer import Viewer
from nbodysim_tpu_torch.diagnostics import profiling
from nbodysim_tpu_torch.kernels.allpairs import allpairs_potential
from nbodysim_tpu_torch.physics import barneshut as bh
from nbodysim_tpu_torch.physics import barneshut3d as bh3
from nbodysim_tpu_torch.render.splat import RenderConfig

CPU = torch.device("cpu")
FIELDS = ("pos", "vel", "acc", "mass", "radius", "frame")
# Host-to-device copies of host constants: syncs no counter holds (the
# outlier flags' True, the block pass's cell floor and window offsets).
UNCOUNTED = ("torch.tensor(", "is_out[out_i] = True")


def _merger_config(n: int, **kw) -> nt.SimConfig:
    fields = dict(n=n, integrator="leapfrog_kdk", dt=0.05,
                  force_backend="bh", bh_deep_levels=-1,
                  collision_broad_phase="block", collision_cell_size=0.0)
    return nt.SimConfig(**{**fields, **kw})


def _merger(n: int, device, **kw) -> nt.Simulation:
    cfg = _merger_config(n, **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return nt.Simulation(cfg, state=nt.init_scene(
            "galaxy_merger", cfg, device=device), device=device)


def _plummer(n: int, device, **kw) -> nt.Simulation:
    """BASELINE config 2's physics (leapfrog, dt 0.5, softening 10,
    collisions, boundary and clamp off) on the octree's deep chain."""
    cfg = nt.SimConfig(**{**dict(
        n=n, dim=3, integrator="leapfrog_kdk", dt=0.5, softening=10.0,
        enable_collisions=False, enable_boundary=False,
        enable_velocity_clamp=False, force_backend="bh", bh_deep_levels=-1),
        **kw})
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return nt.Simulation(cfg, state=nt.init_scene(
            "plummer", cfg, virialize=False, device=device), device=device)


STAGES = ["tree.couplings", "tree.pyramid", "tree.downward", "tree.near",
          "tree.deep", "tree.tiles", "tree.assemble"]
PLAIN_STAGES = [x for x in STAGES if x not in ("tree.deep", "tree.tiles")]
# The reads of a device count that a counter of the same count follows.
OVERFLOW_COUNTERS = {"collide_overflow": "collide.overflow",
                     "near_overflow": "tree.near_overflow"}


def _square(n: int, device, **kw) -> nt.Simulation:
    """SimConfig()'s physics on the uniform square, the plain quadtree and
    the bucket collision pass."""
    cfg = nt.SimConfig(**{**dict(n=n, force_backend="bh",
                                 collision_broad_phase="bucket"), **kw})
    return nt.Simulation(cfg, scene="uniform_square", device=device)


# Each tree's CPU step: the module that holds its caps and stages, the caps
# cut so that the deep rows fit their compaction and the tile scatter and
# apply do not, the compactions in the order the step runs them, the reads
# of a device count, the tree's stage spans, the collision pass's stage
# spans, the `tree.m2l` spans each parent stage holds, and the parent stage
# of each read.
TREES = {
    "merger2d": dict(
        module=bh,
        caps={"_deep_rows_cap": lambda n: n // 2,
              "_scatter_cap": lambda n: n // 2,
              "_refined_cap": lambda n: n // 8},
        sim=lambda: _merger(2048, CPU, bh_levels=4, bh_deep_levels=6,
                            bh_tile_levels=2, bh_tile_size=8,
                            bh_tile_count=4),
        compactions=("deep", "scatter", "apply"),
        fits=[True, False, False],
        # The deep rows, the tile scatter, the tile apply, the block pass's
        # residual branch.
        reads=["apply_rows", "collide_overflow", "deep_rows",
               "scatter_rows"],
        stages=STAGES,
        collide=["collide.structure", "collide.planes", "collide.block",
                 "collide.corrections"],
        # Levels 2-4, deep levels 5-6, tile sub-levels 1-2.
        m2l={"tree.downward": 3, "tree.deep": 2, "tree.tiles": 2},
        read_in={"deep_rows": "tree.deep", "scatter_rows": "tree.tiles",
                 "apply_rows": "tree.tiles",
                 "collide_overflow": "collide.corrections"}),
    "plummer3d": dict(
        module=bh3,
        caps={"_deep_rows_cap3": lambda n: (3 * n) // 4,
              "_scatter_cap3": lambda n: n // 2,
              "_refined_cap3": lambda n: n // 8},
        sim=lambda: _plummer(2048, CPU, bh_levels=3, bh_deep_levels=5,
                             bh_tile_levels=2, bh_tile_size=4,
                             bh_tile_count=4, bh_nf_sparse=1),
        compactions=("sparse_targets", "sparse_sources", "deep", "scatter",
                     "apply"),
        # The sparse sources' count fits their cap, but the cap is N at
        # this size: they take all rows.
        fits=[True, True, True, False, False],
        # The sparse near field's targets and sources, whether any target
        # takes the deep path, the deep rows, the tile scatter and apply.
        reads=["apply_rows", "deep_rows", "deep_targets", "scatter_rows",
               "sparse_sources", "sparse_targets"],
        stages=STAGES,
        collide=[],
        # Levels 2-3, deep levels 4-5, tile sub-levels 1-2.
        m2l={"tree.downward": 2, "tree.deep": 2, "tree.tiles": 2},
        read_in={"sparse_targets": "tree.near", "sparse_sources": "tree.near",
                 "deep_targets": "tree.deep", "deep_rows": "tree.deep",
                 "scatter_rows": "tree.tiles", "apply_rows": "tree.tiles"}),
    "square2d": dict(
        module=bh,
        caps={},
        # 32 bodies a finest cell of the 8^2 grid: past the cap of 16, so
        # the tree's residual runs.
        sim=lambda: _square(2048, CPU, bh_levels=3, collision_grid_res=16),
        compactions=(),
        fits=[],
        # The tree's residual branch, the bucket pass's residual branch.
        reads=["collide_overflow", "near_overflow"],
        stages=PLAIN_STAGES,
        collide=["collide.bucket_grid", "collide.stencil",
                 "collide.corrections"],
        # Levels 2-3.
        m2l={"tree.downward": 2},
        read_in={"near_overflow": "tree.near",
                 "collide_overflow": "collide.corrections"}),
}


def _expected_rows(what: str, need: int, cap: int, n: int):
    """(needed, computed) of a compaction whose mask counts `need` rows
    under capacity `cap`: a compaction computes its capacity where the
    count fits, else all n; the sparse near field runs on its valid
    targets alone (the rest promote to the deep path) and on its
    compacted sources, or on all n where they do not fit below n."""
    if what == "sparse_targets":
        return min(need, cap), min(need, cap)
    if what == "sparse_sources":
        return need, need if need <= cap < n else n
    return need, cap if need <= cap else n


def _step_from(sim, state, record: bool):
    """One step of `sim` from `state`; (state after, recorder or None)."""
    sim.state = state
    if not record:
        return sim.run(1), None
    with profiling.recording() as rec:
        out = sim.run(1)
    return out, rec


def _assert_same_state(a, b):
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.fixture(scope="module", params=sorted(TREES))
def tree_step(request):
    """One step of a tree's N = 2048 case (`TREES`) from the same state
    with recording off and on. Returns the case, the states, the recorder,
    the compactions' mask counts and caps, and the host_read calls and the
    values they returned."""
    case = TREES[request.param]
    mod = case["module"]
    with pytest.MonkeyPatch.context() as mp:
        for name, cap in case["caps"].items():
            mp.setattr(mod, name, cap)
        sim = case["sim"]()
        state0 = sim.state
        off, _ = _step_from(sim, state0, record=False)

        masks, reads, values = [], [], []
        compact, read = mod._compact_indices, profiling.host_read

        def spy_compact(mask, cap):
            masks.append((int(mask.sum()), cap))
            return compact(mask, cap)

        def spy_read(t, what):
            reads.append(what)
            values.append(read(t, what))
            return values[-1]

        # The tree's own compactions (the octree's sparse near field) and
        # the pipeline's (the deep rows, the tile scatter and apply).
        for m in {bh, mod}:
            mp.setattr(m, "_compact_indices", spy_compact)
        mp.setattr(profiling, "host_read", spy_read)
        on, rec = _step_from(sim, state0, record=True)
    return dict(case=case, off=off, on=on, rec=rec, masks=masks,
                reads=reads, values=values)


@pytest.mark.parametrize("tree", sorted(t for t, case in TREES.items()
                                        if "tree.deep" in case["stages"]))
def test_one_pipeline_serves_both_trees(monkeypatch, tree):
    """The quadtree and the octree run the one pipeline of
    `physics/barneshut.py`: a wrap of its `_exact_couplings` and
    `_tile_refine` sees the calls of either tree's deep-chain step."""
    calls = []
    for name in ("_exact_couplings", "_tile_refine"):
        def wrap(*a, _real=getattr(bh, name), _name=name, **k):
            calls.append(_name)
            return _real(*a, **k)

        monkeypatch.setattr(bh, name, wrap)
    sim = TREES[tree]["sim"]()        # leapfrog: primes the forces once
    assert sim.config.dim == (3 if tree == "plummer3d" else 2)
    assert calls == ["_exact_couplings", "_tile_refine"]


def test_nothing_recording_keeps_no_span():
    assert profiling._recorder is None
    # Off, a span is one shared object: nothing is allocated or kept.
    assert profiling.span("step") is profiling.span("tree.deep")
    sim = nt.Simulation(nt.SimConfig(n=256), scene="uniform_disc",
                        device=CPU)
    with profiling.recording() as before:
        pass
    sim.run(2)
    assert profiling.host_read(sim.state.frame, "frame") == 2
    assert before.spans == [] and before.counters == {"host_syncs": 0}
    with profiling.recording() as rec:
        sim.run(1)
    assert [s.name for s in rec.select("step")] == ["step"]
    assert rec.device_ms("step") is None           # no card: no events
    assert profiling._recorder is None


def test_recording_leaves_the_merger_step_bit_identical(tree_step):
    _assert_same_state(tree_step["off"], tree_step["on"])


def test_row_counters_equal_the_masks(tree_step):
    """Each compaction's needed and computed rows follow from its mask's
    count and its capacity (`_expected_rows`). The caps make the deep rows
    fit and the tile scatter and apply run over every row."""
    n = 2048
    case = tree_step["case"]
    cnt = tree_step["rec"].counters
    assert len(tree_step["masks"]) == len(case["compactions"])
    fits = []
    for what, (need, cap) in zip(case["compactions"], tree_step["masks"]):
        assert need > 0
        needed, computed = _expected_rows(what, need, cap, n)
        assert cnt[f"tree.rows_needed.{what}"] == needed, what
        assert cnt[f"tree.rows_computed.{what}"] == computed, what
        fits.append(need <= cap)
    assert fits == case["fits"]


def test_host_syncs_count_the_host_reads(tree_step):
    reads = tree_step["reads"]
    assert sorted(reads) == tree_step["case"]["reads"]
    rec = tree_step["rec"]
    assert rec.counters["host_syncs"] == len(reads)
    assert [s.name for s in rec.select("host_read.")] == [
        f"host_read.{r}" for r in reads]


def test_overflow_counters_equal_the_reads(tree_step):
    """`collide.overflow` and `tree.near_overflow` hold the counts that
    their reads returned, and only where those reads ran."""
    read = Counter()
    for what, value in zip(tree_step["reads"], tree_step["values"]):
        if what in OVERFLOW_COUNTERS:
            # The tree's read holds the count, then the residual's slices.
            read[OVERFLOW_COUNTERS[what]] += (
                value[0] if what == "near_overflow" else value)
    cnt = tree_step["rec"].counters
    assert {k: cnt[k] for k in OVERFLOW_COUNTERS.values() if k in cnt} \
        == dict(read)
    if "near_overflow" in tree_step["case"]["reads"]:
        assert cnt["tree.near_overflow"] > 0      # the residual ran


def test_spans_nest(tree_step):
    case = tree_step["case"]
    rec = tree_step["rec"]
    names = [s.name for s in rec.spans]
    parents = [rec.spans[s.parent].name if s.parent is not None else None
               for s in rec.spans]
    parent = dict(zip(names, parents))
    assert parent["step"] is None
    assert parent["forces"] == "step"
    stages = case["stages"]
    assert [x for x in names if x.startswith("tree.")
            and x != "tree.m2l"] == stages
    assert [x for x in names if x.startswith("collide.")] == case["collide"]
    assert all(parent[x] == "forces" for x in stages)
    if case["collide"]:
        assert parent["collisions"] == "step"
        assert all(parent[x] == "collisions" for x in case["collide"])
    else:
        assert "collisions" not in names
    assert Counter(p for x, p in zip(names, parents)
                   if x == "tree.m2l") == Counter(case["m2l"])
    for what, stage in case["read_in"].items():
        assert parent[f"host_read.{what}"] == stage, what
    assert rec.under(names.index(stages[-2]), "step")
    for i, s in enumerate(rec.spans):
        if s.parent is not None:
            p = rec.spans[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns, s.name
    summary = rec.summary()
    assert list(summary)[:2] == ["step", "forces"]
    assert summary["step"]["calls"] == 1
    assert sum(rec.host_ms(x) for x in stages) <= rec.host_ms("forces") \
        <= rec.host_ms("step")


def test_viewer_spans_and_host_reads():
    v = Viewer(nt.SimConfig(n=256), render_config=RenderConfig(
        width=32, height=24, scale=0.005), steps_per_frame=2, device=CPU)
    launches = allpairs_potential.launches
    with profiling.recording() as rec:
        v.frame()
        hud = v.hud_text()
    assert allpairs_potential.launches == launches   # the CPU: plain path
    assert "| frame 2 |" in hud
    assert [s.name for s in rec.spans if s.parent is None] == [
        "step", "step", "render", "hud"]
    assert {s.name for s in rec.select("host_read.", under="hud")} == {
        "host_read.hud_energy", "host_read.frame"}
    assert rec.counters["host_syncs"] == 2


def test_host_read_values_and_counters():
    t = torch.tensor(7, dtype=torch.int64)
    assert profiling.host_read(t, "x") == 7
    profiling.count("rows", 3)                # nothing records: dropped
    with profiling.recording() as rec:
        assert profiling.host_read(torch.tensor(True), "b") is True
        assert profiling.host_read(torch.tensor(2.5), "f") == 2.5
        profiling.count("rows", 3)
        profiling.count("rows", 4)
        with profiling.recording() as inner:
            profiling.count("rows", 1)
        profiling.count("rows", 1)
    assert rec.counters == {"host_syncs": 2, "rows": 8}
    assert inner.counters == {"host_syncs": 0, "rows": 1}


def test_trace_holds_the_spans(tmp_path):
    sim = nt.Simulation(nt.SimConfig(n=64, force_backend="torch"),
                        scene="plummer", device=CPU)
    with profiling.trace(str(tmp_path / "tr")):
        sim.run(2)
        assert sim.frame == 2
    (path,) = (tmp_path / "tr").glob("trace_*.json")
    names = [str(e.get("name", ""))
             for e in json.loads(path.read_text())["traceEvents"]]
    for span in ("step", "forces", "collisions", "host_read.frame"):
        assert span in names, span
    assert names.count("step") == 2
    assert any(x.startswith("aten::") for x in names)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def _syncs(fn):
    """fn() under the sync debug mode "warn": the (file name, line text) of
    each synchronizing call it made, and fn's result."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    sites = [(Path(w.filename).name,
              linecache.getline(w.filename, w.lineno).strip())
             for w in caught
             if "called a synchronizing" in str(w.message)]
    return sites, out


def _check_syncs_are_the_host_reads(sim):
    """One step of `sim`: the syncs in `host_read` are `host_syncs`, every
    other sync is an uncounted copy of a host constant, and recording adds
    none. Returns the recorder."""
    sim.run(1)
    state0 = sim.state
    off, _ = _syncs(lambda: _step_from(sim, state0, record=False))
    on, (_, rec) = _syncs(lambda: _step_from(sim, state0, record=True))
    assert Counter(f for f, _ in on) == Counter(f for f, _ in off)
    counted = [s for s in on if s[0] == "profiling.py"]
    assert len(counted) == rec.counters["host_syncs"] >= 4
    rest = [s for s in on if s[0] != "profiling.py"]
    assert all(any(u in line for u in UNCOUNTED) for _, line in rest), rest
    assert rec.counters["tree.rows_computed.deep"] > 0
    return rec


def _check_step_bit_identical(sim):
    """With index_add_ deterministic, recording changes no bit of the
    step."""
    sim.run(1)
    state0 = sim.state
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        off, _ = _step_from(sim, state0, record=False)
        on, rec = _step_from(sim, state0, record=True)
    finally:
        torch.use_deterministic_algorithms(False)
    _assert_same_state(off, on)
    assert rec.device_ms("forces") > 0


@pytest.mark.cuda
def test_card_merger_syncs_are_the_host_reads(dev):
    """One step of the N = 131,072 deep-chain merger (its compactions at
    their own caps, the block pass)."""
    _check_syncs_are_the_host_reads(_merger(131_072, dev))


@pytest.mark.cuda
def test_card_plummer_syncs_are_the_host_reads(dev):
    """One step of the N = 131,072 Plummer sphere under config 2's physics
    (the octree's deep chain at its own caps, K7): whether any target takes
    the deep path, the deep rows, the tile scatter and apply."""
    rec = _check_syncs_are_the_host_reads(_plummer(131_072, dev))
    assert {s.name for s in rec.select("host_read.")} == {
        "host_read.deep_targets", "host_read.deep_rows",
        "host_read.scatter_rows", "host_read.apply_rows"}
    assert {s.name for s in rec.select("tree.m2l", under="tree.deep")}


def _check_m2l_runs_the_kernel(sim, kernel, counter, expected):
    """One step of `sim` after its first: `expected` launches of the M2L
    kernel `kernel` (its counter `counter`), as many `tree.m2l` spans,
    nothing under them that calls cuDNN or copies memory, and the forces
    within a median 1e-4 (and 1e-3 of the largest) of the same state's CPU
    plain route. Returns the recorder."""
    launches = kernel.launches
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    with prof, profiling.recording() as rec:
        sim.run(1)
    torch.cuda.synchronize()
    assert rec.counters[counter] == expected
    assert kernel.launches == launches + expected
    events = [e for e in prof.events()
              if e.device_type != torch.autograd.DeviceType.CUDA]
    m2l = [e.time_range for e in events if e.name == "tree.m2l"]
    assert len(m2l) == expected
    inside = [e.name for e in events if e.name != "tree.m2l" and any(
        r.start <= e.time_range.start <= r.end for r in m2l)]
    assert not [x for x in inside if "cudnn" in x or "conv" in x
                or "Memcpy" in x or x.startswith("aten::copy_")], inside

    cfg = sim.config
    pos, mass = sim.state.pos, sim.state.mass
    got = nt.compute_accelerations(pos, mass, cfg)
    ref = nt.compute_accelerations(pos.cpu(), mass.cpu(), cfg)
    err = (got.cpu() - ref).norm(dim=1) / ref.norm(dim=1)
    assert float(err.median()) < 1e-4
    assert float((got.cpu() - ref).abs().max()) <= 1e-3 * float(
        ref.abs().max())
    return rec


@pytest.mark.cuda
def test_card_merger_m2l_runs_the_kernel(dev, monkeypatch):
    """One step of the N = 131,072 deep-chain merger after its first: every
    M2L level the config resolves (levels 2..L, the deep levels, the tile
    sub-levels) is one launch of the 2D M2L kernel (`m2l2.launches`),
    nothing under `tree.m2l` calls cuDNN or copies memory, `host_syncs`
    equals the same step's with the M2L on its plain route, and the forces
    match the same state's CPU plain route."""
    from nbodysim_tpu_torch.kernels import m2l2 as km2

    sim = _merger(131_072, dev)
    sim.run(1)
    cfg = sim.config
    levels = bh._resolve_levels(cfg, cfg.n)
    deep = bh._resolve_deep_levels(cfg, levels)
    tk, _, _ = bh._resolve_tile_params(cfg, deep, bh._resolve_radius(cfg))
    assert deep and tk
    state0 = sim.state
    with monkeypatch.context() as mp:
        mp.setattr(bh, "m2l2", km2.m2l2_plain)
        _, plain = _step_from(sim, state0, record=True)
    sim.state = state0
    rec = _check_m2l_runs_the_kernel(
        sim, km2.m2l2, "m2l2.launches", (levels - 1) + (deep - levels) + tk)
    assert rec.counters["host_syncs"] == plain.counters["host_syncs"] >= 3


@pytest.mark.cuda
def test_card_plummer_m2l_runs_the_kernel(dev):
    """One step of the N = 131,072 Plummer sphere after its first: every
    M2L level the config resolves (levels 2..L, the deep levels, the tile
    sub-levels) is one launch of the M2L kernel (`m2l3.launches`), nothing
    under `tree.m2l` calls cuDNN or copies memory, `host_syncs` stays the
    four reads, and the forces match the same state's CPU plain route."""
    from nbodysim_tpu_torch.kernels.m2l3 import m2l3

    sim = _plummer(131_072, dev)
    sim.run(1)
    cfg = sim.config
    n = cfg.n
    levels = bh3._resolve_levels3(cfg, n)
    deep = bh3._resolve_deep_levels3(cfg, levels)
    tk, _, _ = bh3._resolve_tile_params3(cfg, deep, bh3._resolve_radius3(cfg))
    assert deep and tk
    rec = _check_m2l_runs_the_kernel(sim, m2l3, "m2l3.launches",
                                     (levels - 1) + (deep - levels) + tk)
    assert rec.counters["host_syncs"] == 4


@pytest.mark.cuda
def test_card_merger_step_bit_identical(dev):
    _check_step_bit_identical(_merger(131_072, dev))


@pytest.mark.cuda
def test_card_plummer_step_bit_identical(dev):
    _check_step_bit_identical(_plummer(131_072, dev))


@pytest.mark.cuda
def test_card_disc_run_makes_no_host_sync(dev):
    sim = nt.Simulation(nt.SimConfig(n=25_000), scene="uniform_disc",
                        device=dev)
    sim.run(1)

    def run10():
        with profiling.recording() as rec:
            sim.run(10)
        return rec

    sites, rec = _syncs(run10)
    assert sites == [] and rec.counters["host_syncs"] == 0
    assert len(rec.select("step")) == 10
    assert rec.device_ms("step") > 0


@pytest.mark.cuda
def test_card_viewer_hud_launches_the_potential_kernel_once(dev):
    """On the N = 25,000 disc a frame's hud_text() launches the potential
    kernel once and syncs only in its two host_reads (the energy, the
    frame)."""
    v = Viewer(nt.SimConfig(n=25_000), render_config=RenderConfig(
        width=90, height=68, scale=0.005), steps_per_frame=2, device=dev)
    v.frame()
    v.hud_text()
    v.frame()
    launches = allpairs_potential.launches

    def hud():
        with profiling.recording() as rec:
            text = v.hud_text()
        return rec, text

    sites, (rec, text) = _syncs(hud)
    assert allpairs_potential.launches == launches + 1
    assert "| frame 4 |" in text
    assert [s.name for s in rec.select("host_read.", under="hud")] == [
        "host_read.hud_energy", "host_read.frame"]
    assert rec.counters["host_syncs"] == 2
    assert [f for f, _ in sites] == ["profiling.py"] * 2, sites
