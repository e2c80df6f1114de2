"""Irregular-grid (Voronoi) wavefront sweep.

Reference parity: src/irregular_ray_tracing.jl (Delaunay_upII/_downII):
BFS layers from the boundary wall; within each layer n_sweeps relaxation
passes; per site, blend the formal solutions along the two most-upwind
Delaunay edges (the edge IS the characteristic -- intensities are read at
upwind sites directly, no interpolation).

Design: the per-site serial loop becomes a **slot-ordered** scan.
Sites are renumbered per direction into schedule order so that every
level/layer/bin occupies a contiguous row range of a (n_slots, B) array:

  [ boundary sites | stage-0 row 0 | stage-0 row 1 | ... | stage-k rows ]

The per-level update is then
  gather upwinds (one flat jnp.take)  ->  fused FMA formal solution
  ->  jax.lax.dynamic_update_slice  (contiguous, no scatter!)
which avoids scatters and multi-dimensional gathers altogether: flat
row-takes and DUS vectorize across the trailing lane axis.

lax.scan walks the levels (the irreducibly sequential wavefront
direction); within a level all sites and the wavelength batch update
simultaneously.  The reference's in-layer Gauss-Seidel order is
reproduced EXACTLY by the occurrence-resolved gs schedule
(grid/voronoi.py _gs_layer_schedule): each site gets one slot per pass
and readers target the occurrence of the pass their value must come
from, so parallel rows with Jacobi reads give bitwise Gauss-Seidel
semantics (pinned end-to-end by tests/test_nlte_parity.py).

Ordering modes (grid/voronoi.py build_voronoi_plan):
  'layer' (default, reference parity): BFS wall-distance layers,
    n_sweeps exact Gauss-Seidel passes per layer.  Fixed pass counts
    truncate horizontal propagation -- at grazing angles (10 of the 12
    production ul7n12 directions have |mu| <= 0.42) most of a
    zero-opacity beam is lost.
  'wavefront': exact Kahn levels over the 2-upwind dependency DAG (one
    pure-gather pass per level, every upwind already final) plus
    s = pos.k sorted bins with global repeats for seam-wrapping chains.
    Reaches the global fixed point of the per-site equations (tests).

Shapes: public API takes fields (B, n); slot arrays carry one extra
zero row (the dummy slot) so padded upwind entries gather harmlessly.
"""

from __future__ import annotations

import dataclasses
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .. import memory
from .formal import linear_weights

# Buffer donation for the host-orchestrated stage/lap calls: without it
# XLA keeps input AND output intensity buffers live across every call
# (doubling the (n_slots+1, B) carry, ~1.5 GB at 3.5e6 sites x 91
# lambda) and the hoisted-weight precompute double-buffers its multi-GB
# (A, b) pair.  The host loops drop
# their references before each call, which is what donation requires.
# VRT_DONATE=0 is an A/B escape hatch for allocator forensics.
_DONATE = os.environ.get("VRT_DONATE", "1") != "0"


def _don(*idx):
    return idx if _DONATE else ()


# ------------------------------------------------------------ slot plan

@dataclasses.dataclass(frozen=True)
class SlotStage:
    """One schedule stage in slot order.

    Rows [base + l*W, base + (l+1)*W) of the slot array are level l.
    up/w/r: (L, W, 2) upwind SLOT ids / blend weights / path lengths.
    passes: Jacobi passes per level (1 for exact topological levels).
    repeats: global repeats of the stage (seam-wrapping relaxation).
    kind: 'exact' | 'relax' | 'gs' | 'layer'.  Only 'relax' stages can
    repeat; repeats is therefore a TRACED scalar in the device sweep so
    directions with different repeat counts share one compiled kernel.
    """
    base: int
    L: int
    W: int
    up: np.ndarray
    w: np.ndarray
    r: np.ndarray
    passes: int
    repeats: int
    kind: str = "exact"


@dataclasses.dataclass(frozen=True)
class SlotPlan:
    n_slots: int
    n_bc: int
    slot_gather: np.ndarray   # (n_slots,) site id per slot (clipped pad)
    site_gather: np.ndarray   # (n,) slot id per site
    stages: tuple


def _schedule_stages(plan, n_sweeps):
    """(schedule (L,W), passes, kind, repeats, occ) in execution order."""
    if getattr(plan, "exact_levels", None) is not None or \
            getattr(plan, "relax_levels", None) is not None:
        out = []
        if plan.exact_levels is not None:
            out.append((plan.exact_levels, 1, "exact", 1, None))
        if plan.relax_levels is not None:
            out.append((plan.relax_levels, 1, "relax",
                        int(getattr(plan, "relax_repeats", 1)), None))
        return out
    if getattr(plan, "gs_levels", None) is not None:
        # exact Gauss-Seidel row order (grid/voronoi.py
        # _gs_layer_schedule): n_sweeps is already baked into the rows
        return [(plan.gs_levels, 1, "gs", 1,
                 getattr(plan, "gs_up_occ", None))]
    return [(plan.layer_sites, n_sweeps, "layer", 1, None)]


def _bucket(x):
    """Round x up on a ~1/16-relative power-of-two grid.

    The 12 per-direction slot plans have nearly identical but not equal
    stage shapes (level counts/widths spread ~1-6% across directions at
    production scale); padding every shape up to the next point of a
    coarse grid collapses them to ONE jit cache entry per stage kind
    instead of 12 full compiles.  Worst-case padding is 1/16
    of the array (grid step = 2^(bits-4)); pad rows read the dummy zero
    slot with weight 0 and write zeros to pad slots, so real-site
    results are bitwise unchanged (tests/test_sweep_voronoi.py)."""
    if x <= 8:
        return int(x)
    g = 1 << max(int(x).bit_length() - 4, 3)
    return int(-(-x // g) * g)


def share_plan_shapes(plans, n_sweeps=3):
    """Attach common pad targets to a set of direction plans.

    Directions with the same stage structure (tuple of stage kinds) are
    grouped; every member is padded to the group's maximum per-stage
    (L, W), bc count and slot count, so their slot plans have IDENTICAL
    traced shapes and the whole group shares ONE `_sweep_slots` compile
    (repeat counts are traced).  With shared shapes the ul7n12
    quadrature needs one compile per group (typically 2: the
    exact-only and the exact+relax directions).  Padding cost is the
    max-vs-own shape difference (~1-2% at production scale where the
    12 directions' schedules are near-identical in size).

    Call after building all plans for a quadrature and before the first
    sweep; sweep results are bitwise unchanged (pad rows read the dummy
    zero slot with weight 0 and write zeros to pad slots).
    """
    groups = {}
    for p in plans:
        raw = _schedule_stages(p, n_sweeps)
        # cluster key: stage kinds + bucketed level widths.  Padding a
        # group to elementwise (L, W) maxima is quadratically wasteful
        # when members' L and W are anti-correlated (wide levels <->
        # fewer levels: (65,128) and (33,256) pad to (67,256), +104%
        # rows), so directions only share a compile when their widths
        # land in the same ~1/16 bucket -- at production scale that is
        # still 2-5 compiles for the 12 ul7n12 directions with ~1-2%
        # row padding.
        # both axes are bucketed: members with same-bucket widths but
        # very different level counts would otherwise pad one member's
        # rows up to the group max L (the same quadratic-waste scenario
        # as W, via the other axis)
        kinds = tuple((k, _bucket(np.asarray(s).shape[0]),
                       _bucket(np.asarray(s).shape[1]))
                      for s, _, k, _, _ in raw)
        n = p.n
        # orphan count: sites in no schedule row (and not bc) still get
        # read-only slots, so they contribute to n_slots
        present = np.zeros(n + 1, dtype=bool)
        present[np.asarray(p.bc_sites, dtype=np.int64)] = True
        for sched, *_ in raw:
            present[np.minimum(np.asarray(sched, dtype=np.int64).reshape(-1),
                               n)] = True
        orphans = int(n - np.count_nonzero(present[:n]))
        g = groups.setdefault(kinds, {"LW": [[0, 0] for _ in raw],
                                      "n_bc": 0, "members": []})
        for t, (sched, *_) in zip(g["LW"], raw):
            L, W = np.asarray(sched).shape
            t[0] = max(t[0], L)
            t[1] = max(t[1], W)
        g["n_bc"] = max(g["n_bc"], len(p.bc_sites))
        g["members"].append((p, orphans))
    for kinds, g in groups.items():
        LW = tuple((int(L), int(W)) for L, W in g["LW"])
        fixed = g["n_bc"] + sum(L * W for L, W in LW)
        n_slots = max(fixed + orph for _, orph in g["members"])
        target = (LW, int(g["n_bc"]), int(n_slots), int(n_sweeps))
        for p, _ in g["members"]:
            object.__setattr__(p, "_pad_to", target)
            # drop stale slot plans built before sharing
            object.__setattr__(p, "_slot_cache", {})
    return plans


def build_slot_plan(plan, n_sweeps=3, bucket=True):
    """Compile the slot renumbering for one direction (host, cached).

    Every real site appears in exactly one schedule row (bc sites form
    slot block 0); padding entries (site id == n) map to the dummy slot
    n_slots, whose row stays zero.

    Shapes entering the jit cache key -- bc block, stage (L, W), total
    slot count -- are padded so directions share compiled sweeps:
    exactly, to the group targets attached by `share_plan_shapes`
    (preferred; guaranteed sharing); otherwise, with bucket=True
    (default), up to a coarse power-of-two grid (_bucket) that collapses
    near-equal shapes opportunistically.  Real-site results are bitwise
    unchanged either way.
    """
    pad_to = getattr(plan, "_pad_to", None)
    if not bucket:
        # bucket=False is an explicit opt-out of ALL padding (raw
        # shapes), including group targets attached by share_plan_shapes
        # -- the padding-bound test compares against this baseline
        pad_to = None
    if pad_to is not None and pad_to[3] != n_sweeps:
        # layer-mode schedule rows scale with n_sweeps: targets computed
        # for a different count would mis-pad; fall back to bucketing.
        # Loud: silently dropping the target re-opens the 12-per-
        # direction recompiles with no signal.
        import warnings
        warnings.warn(
            "build_slot_plan n_sweeps=%d does not match the "
            "share_plan_shapes target n_sweeps=%d: shape sharing is "
            "disabled for this call and each direction may recompile "
            "its own sweep. Re-run share_plan_shapes(plans, n_sweeps) "
            "with the sweep's n_sweeps." % (n_sweeps, pad_to[3]),
            stacklevel=2)
        pad_to = None
    cache = getattr(plan, "_slot_cache", None)
    if cache is None:
        cache = {}
        object.__setattr__(plan, "_slot_cache", cache)
    key = (n_sweeps, bool(bucket), pad_to)
    if key in cache:
        return cache[key]

    n = plan.n
    raw = _schedule_stages(plan, n_sweeps)
    n_bc = len(plan.bc_sites)
    if pad_to is not None:
        n_bc_pad = pad_to[1]
    else:
        n_bc_pad = _bucket(n_bc) if bucket else n_bc
    blocks = [np.asarray(plan.bc_sites, dtype=np.int64),
              np.full(n_bc_pad - n_bc, n, dtype=np.int64)]
    base = n_bc_pad
    metas = []
    staged = []
    for si, (sched, passes, kind, repeats, occ) in enumerate(raw):
        sched = np.asarray(sched, dtype=np.int64)
        L, W = sched.shape
        if pad_to is not None or bucket:
            if pad_to is not None:
                Lp, Wp = pad_to[0][si]
            else:
                Lp, Wp = _bucket(L), _bucket(W)
            if (Lp, Wp) != (L, W):
                padded = np.full((Lp, Wp), n, dtype=np.int64)
                padded[:L, :W] = sched
                sched = padded
                if occ is not None:
                    # occ is a flat row*W + col index: remap to the
                    # padded row stride Wp before embedding
                    occ_p = np.full((Lp, Wp, 2), -1, dtype=occ.dtype)
                    occ_p[:L, :W] = np.where(
                        occ >= 0, (occ // W) * Wp + occ % W, occ)
                    occ = occ_p
                L, W = Lp, Wp
        blocks.append(sched.reshape(-1))
        staged.append((sched, occ))
        metas.append((base, L, W, passes, kind, repeats))
        base += L * W
    slot2site = np.concatenate(blocks)

    # sites absent from every schedule row (the reference's skipped last
    # perm site, unreachable layer-0 sites) still appear as UPWINDS of
    # scheduled sites: give them read-only slots so their S/alpha gather
    # real values while their intensity stays the initial 0 (exactly the
    # reference's behaviour) -- the dummy zero row is only for padding.
    present = np.zeros(n, dtype=bool)
    real_entries = slot2site[slot2site < n]
    present[real_entries] = True
    orphans = np.nonzero(~present)[0]
    if orphans.size:
        slot2site = np.concatenate([slot2site, orphans])
    n_slots = len(slot2site)
    ns_pad = n_slots
    if pad_to is not None:
        ns_pad = pad_to[2]
        assert ns_pad >= n_slots, "stale _pad_to: re-run share_plan_shapes"
    elif bucket:
        ns_pad = _bucket(n_slots)
    if ns_pad != n_slots:
        slot2site = np.concatenate(
            [slot2site, np.full(ns_pad - n_slots, n, dtype=np.int64)])
        n_slots = ns_pad

    site2slot = np.full(n + 1, n_slots, dtype=np.int64)  # dummy -> zero row
    real = slot2site < n
    site2slot[slot2site[real]] = np.nonzero(real)[0]

    up_pad = np.concatenate(
        [plan.upwind.astype(np.int64), [[n, n]]], axis=0)   # (n+1, 2)
    w_pad = np.concatenate([plan.weights, [[0.0, 0.0]]], axis=0)
    r_pad = np.concatenate([plan.r, [[0.0, 0.0]]], axis=0)

    stages = []
    for (sched, occ), (b, L, W, passes, kind, repeats) in zip(staged, metas):
        sc = sched
        up_slots = site2slot[up_pad[sc]]                 # (L, W, 2) slots
        if kind == "gs" and occ is not None:
            # exact-GS stage: a site occurs once per pass; readers whose
            # upwind lives in the same layer target the occurrence of the
            # pass their value must come from (grid/voronoi.py
            # _gs_layer_schedule); -1 keeps the site-level resolution
            up_slots = np.where(occ >= 0, b + occ, up_slots)
        stages.append(SlotStage(
            base=b, L=L, W=W,
            up=up_slots.astype(np.int32),
            w=w_pad[sc], r=r_pad[sc],
            passes=passes, repeats=repeats, kind=kind))

    sp = SlotPlan(n_slots=n_slots, n_bc=n_bc_pad,
                  slot_gather=np.minimum(slot2site, n - 1).astype(np.int32),
                  site_gather=site2slot[:n].astype(np.int32),
                  stages=tuple(stages))
    cache[key] = sp
    return sp


def _device_arrays(sp):
    """Device-resident geometry, built once per slot plan (not
    re-uploaded on every sweep).

    One flat per-level schedule per stage.  NOTE: the stage scan is a
    SINGLE lax.scan -- every level of loop nesting makes XLA buffer the
    carried intensity array once more, so the flat form keeps the
    production shapes' temporaries near one intensity buffer.

    Kept per x64 mode: the weights and path lengths upload in the
    default float dtype, and a float64 sweep after a float32 one in the
    same process must not read them rounded to float32."""
    caches = getattr(sp, "_dev_cache", None)
    if caches is None:
        caches = {}
        object.__setattr__(sp, "_dev_cache", caches)
    x64 = bool(jax.config.jax_enable_x64)
    if x64 not in caches:
        # ensure_compile_time_eval: the cache must hold REAL device
        # arrays even when the first sweep_voronoi call happens inside
        # an outer jit trace (otherwise tracers leak into the cache and
        # poison every later call)
        with jax.ensure_compile_time_eval():
            # slot id -> site id, dummy row included (site 0: its
            # consumers all carry weight 0 / path length 0)
            slot_full = np.concatenate(
                [sp.slot_gather,
                 np.zeros(1, dtype=sp.slot_gather.dtype)])
            stage_arrays = []
            for st in sp.stages:
                L, W = st.L, st.W
                starts = st.base + np.arange(L, dtype=np.int32) * W
                # SITE-id maps: the field gathers read the (n, B)
                # site-ordered arrays directly -- no slot-reordered
                # copies of S/alpha are ever built on device
                up_site = slot_full[st.up]
                row_site = slot_full[
                    st.base + np.arange(L * W, dtype=np.int64)].reshape(
                        L, W)
                stage_arrays.append(
                    (jnp.asarray(starts),
                     jnp.asarray(st.up),
                     jnp.asarray(up_site),
                     jnp.asarray(row_site),
                     jnp.asarray(st.w),
                     jnp.asarray(st.r),
                     int(st.repeats)))
            caches[x64] = (tuple(stage_arrays),
                           jnp.asarray(sp.site_gather), int(sp.n_slots))
    return caches[x64]


# ---------------------------------------------------------- device sweep

# A relax stage's precomputed lean weights are hoisted out of the
# repeat loop within memory.hoist_bytes(): the repeat laps then run
# "lean" -- no field arguments at all, so the per-call argument-layout
# copies of S/alpha are paid once per stage, not once per lap.  The
# lean format is PACKED: A = w * ew (L, W, 2, B) and the
# weight-contracted source b = sum_j w_j src_j (L, W, B) -- 3 lanes/row
# instead of the 4 of raw (ew, src), so both the resident bytes and the
# per-lap reads drop 25%.  Donated chunked builds (memory.lean_chunk_rows
# rows per call) keep exactly one copy live (see _lean_chunk).


def _level_src_ew(S_T, a_T, B, up_site, row_site, r2):
    """Field-dependent weights for one level (or a whole stage when the
    leading axis is L): gathers of the upwind and own-site field values
    straight from the (n, B) site-ordered arrays."""
    s_u = jnp.take(S_T, up_site.reshape(-1), axis=0).reshape(
        up_site.shape + (B,))
    a_u = jnp.take(a_T, up_site.reshape(-1), axis=0).reshape(
        up_site.shape + (B,))
    s_c = jnp.take(S_T, row_site.reshape(-1), axis=0).reshape(
        row_site.shape + (B,))
    a_c = jnp.take(a_T, row_site.reshape(-1), axis=0).reshape(
        row_site.shape + (B,))
    dtau = r2[..., None] * (a_c[..., None, :] + a_u) * 0.5
    aw, bw, ew = linear_weights(dtau)
    src = aw * s_u + bw * s_c[..., None, :]
    return ew, src


def _stage_scan(I, S_T, a_T, B, stage_xs, W, passes):
    """ONE flat lax.scan over a stage's levels.

    I: (n_slots + 1, B) intensities (dummy zero row at n_slots);
    S_T/a_T: (n, B) site-ordered source/extinction read through
    host-precomputed SITE-id maps (no slot-reordered field copies exist
    on device).  Per level: gather the upwind/own field values, form
    the formal-solution weights, then the irreducibly sequential part:
    flat-take the 2 upwind I rows (SLOT ids -- occurrence semantics
    live in I), fused formal solution, contiguous dynamic_update_slice.

    Deliberately a single scan: each level of loop nesting makes XLA
    buffer the carried intensity array once more."""

    def level(I, lxs):
        start, up_slot, up_site, row_site, w2, r2 = lxs
        ew, src = _level_src_ew(S_T, a_T, B, up_site, row_site, r2)
        fl = up_slot.reshape(-1)
        zero = jnp.zeros((), start.dtype)
        for _ in range(passes):
            i_u = jnp.take(I, fl, axis=0).reshape(W, 2, B)
            i_new = jnp.sum(w2[..., None] * (ew * i_u + src), axis=1)
            I = jax.lax.dynamic_update_slice(I, i_new, (start, zero))
        return I, None

    I, _ = jax.lax.scan(level, I, stage_xs)
    return I


@partial(jax.jit, static_argnames=("W", "passes"),
         donate_argnums=_don(2))
def _run_stage(W, passes, I, xs, S_T, a_T):
    """One schedule stage (exact / gs / layer), I donated in place."""
    B = S_T.shape[1]
    return _stage_scan(I, S_T, a_T, B, xs, W, passes)


@partial(jax.jit, static_argnames=("W", "passes"),
         donate_argnums=_don(2))
def _run_relax_lap(W, passes, I, xs, S_T, a_T):
    """One relax lap + the EXACT sup-change of the lap.

    The change is measured inside the level scan by reading each
    level's old rows (one contiguous dynamic_slice) before the update
    writes them -- exact over every written row (unwritten rows cannot
    change), no second intensity buffer, donation-compatible.  Returns
    (I, rel_diff): the host drives the repeat loop and the
    two-consecutive-sub-tol exit, reading one scalar per lap.
    Keeping the loop OUT of the compiled program matters: XLA buffers
    the carried intensity once per loop-nesting level, while the
    single-scan stage program stays near 1x the intensity buffer with
    donation."""
    B = S_T.shape[1]

    def level(carry, lxs):
        I, dmax, smax = carry
        start, up_slot, up_site, row_site, w2, r2 = lxs
        ew, src = _level_src_ew(S_T, a_T, B, up_site, row_site, r2)
        fl = up_slot.reshape(-1)
        zero = jnp.zeros((), start.dtype)
        for _ in range(passes):
            i_old = jax.lax.dynamic_slice(I, (start, zero), (W, B))
            i_u = jnp.take(I, fl, axis=0).reshape(W, 2, B)
            i_new = jnp.sum(w2[..., None] * (ew * i_u + src), axis=1)
            dmax = jnp.maximum(dmax, jnp.max(jnp.abs(i_new - i_old)))
            smax = jnp.maximum(smax, jnp.max(jnp.abs(i_new)))
            I = jax.lax.dynamic_update_slice(I, i_new, (start, zero))
        return (I, dmax, smax), None

    zero_s = jnp.zeros((), I.dtype)
    (I, dmax, smax), _ = jax.lax.scan(level, (I, zero_s, zero_s), xs)
    return I, dmax / jnp.maximum(smax, jnp.asarray(1e-30, I.dtype))


def _make_I(n_slots, B, dtype, I0):
    I = jnp.zeros((n_slots + 1, B), dtype=dtype)
    return jax.lax.dynamic_update_slice(I, I0.T.astype(dtype), (0, 0))


@partial(jax.jit, static_argnames=("W", "passes"),
         donate_argnums=_don(2))
def _run_hoisted_lap_d(W, passes, I, lean_xs):
    """Hoisted relax lap + exact sup-change (adaptive-exit variant)."""
    B = lean_xs[-1].shape[-1]

    def level(carry, lxs):
        I, dmax, smax = carry
        start, upl, Al, bl = lxs
        fl = upl.reshape(-1)
        zero = jnp.zeros((), start.dtype)
        for _ in range(passes):
            i_old = jax.lax.dynamic_slice(I, (start, zero), (W, B))
            i_u = jnp.take(I, fl, axis=0).reshape(W, 2, B)
            i_new = jnp.sum(Al * i_u, axis=1) + bl
            dmax = jnp.maximum(dmax, jnp.max(jnp.abs(i_new - i_old)))
            smax = jnp.maximum(smax, jnp.max(jnp.abs(i_new)))
            I = jax.lax.dynamic_update_slice(I, i_new, (start, zero))
        return (I, dmax, smax), None

    zero_s = jnp.zeros((), I.dtype)
    (I, dmax, smax), _ = jax.lax.scan(level, (I, zero_s, zero_s),
                                      lean_xs)
    return I, dmax / jnp.maximum(smax, jnp.asarray(1e-30, I.dtype))


@partial(jax.jit, static_argnames=("W", "passes"),
         donate_argnums=_don(2))
def _run_hoisted_lap(W, passes, I, lean_xs):
    """One relax lap from the packed lean weights (A = w * ew, b = sum
    of w * src), hoisted out of the repeat loop within
    memory.hoist_bytes().  Per row the lap reads 2 I rows + 3 lanes of
    lean data -- no field gathers at all."""
    B = lean_xs[-1].shape[-1]

    def level(I, lxs):
        start, upl, Al, bl = lxs
        fl = upl.reshape(-1)
        zero = jnp.zeros((), start.dtype)
        for _ in range(passes):
            i_u = jnp.take(I, fl, axis=0).reshape(W, 2, B)
            i_new = jnp.sum(Al * i_u, axis=1) + bl
            I = jax.lax.dynamic_update_slice(I, i_new, (start, zero))
        return I, None

    I, _ = jax.lax.scan(level, I, lean_xs)
    return I


@partial(jax.jit, static_argnames=("W",), donate_argnums=_don(1, 2))
def _lean_chunk(W, A_buf, b_buf, start, up_site_c, row_site_c, w2_c,
                r2_c, S_T, a_T):
    """One level-chunk of the hoisted-weight precompute, written into
    donated A (L, W, 2, B) / b (L, W, B) buffers."""
    B = S_T.shape[1]
    ew, src = _level_src_ew(S_T, a_T, B, up_site_c, row_site_c, r2_c)
    A = w2_c[..., None] * ew
    b = jnp.sum(w2_c[..., None] * src, axis=2)
    zero = jnp.zeros((), jnp.int32)
    A_buf = jax.lax.dynamic_update_slice(
        A_buf, A, (start, zero, zero, zero))
    b_buf = jax.lax.dynamic_update_slice(b_buf, b, (start, zero, zero))
    return A_buf, b_buf


def _precompute_lean(W, xs, S_T, a_T):
    """(starts, up_slot, A, b) for a whole stage, built in level chunks
    so each call's temp stays near the S/alpha layout copies.  Chunk
    buffers are donated through _lean_chunk: exactly one copy of the
    multi-GB pair is ever live."""
    starts, up_slot, up_site, row_site, w2, r2 = xs
    B = S_T.shape[1]
    L = int(up_site.shape[0])
    rows = memory.lean_chunk_rows(B, S_T.dtype.itemsize)
    lc = max(1, rows // max(W, 1))
    A_buf = jnp.zeros((L, W, 2, B), S_T.dtype)
    b_buf = jnp.zeros((L, W, B), S_T.dtype)
    for l0 in range(0, L, lc):
        l1 = min(l0 + lc, L)
        A_buf, b_buf = _lean_chunk(
            W, A_buf, b_buf, jnp.asarray(l0, jnp.int32),
            up_site[l0:l1], row_site[l0:l1], w2[l0:l1], r2[l0:l1],
            S_T, a_T)
    if A_buf.size * A_buf.dtype.itemsize > (256 << 20):
        # production scale: finish the multi-GB lean build before the
        # laps' dispatch-time allocations stack on its chunks
        jax.block_until_ready(b_buf)
    return (starts, up_slot, A_buf, b_buf)


@jax.jit
def _finish(I, site_gather):
    return jnp.take(I, site_gather, axis=0)             # (n, B)


def hoisted_bytes(rows, repeats, B, itemsize):
    """Bytes of a relax stage's lean weights (3 lanes of B per slot row)
    when they are hoisted out of its repeat loop -- more than one lap,
    within memory.hoist_bytes() -- and 0 when the laps read the fields."""
    nbytes = rows * 3 * B * itemsize
    return nbytes if repeats > 1 and nbytes <= memory.hoist_bytes() else 0


def _sweep_slots(shapes, relax_tol, stage_arrays, site_gather,
                 S_T, a_T, I0):
    """Host-orchestrated slot sweep: one donated jit call per schedule
    stage and per relax lap (see _run_relax_lap for why the loops live
    on the host).  stage_arrays: per-stage (starts, up_slot, up_site,
    row_site, w, r, repeats).  A repeated relax stage hoists its lean
    weights when they fit memory.hoist_bytes().  S_T/a_T: (n, B)
    site-ordered fields (pre-transposed by the caller)."""
    n_slots, stage_shapes = shapes
    B = S_T.shape[1]
    I = _make_I(n_slots, B, S_T.dtype, I0)

    for (kind, W, passes), sa in zip(stage_shapes, stage_arrays):
        *xs, repeats = sa
        xs = tuple(xs)
        n_reps = int(repeats)
        if kind != "relax":
            I = _run_stage(W, passes, I, xs, S_T, a_T)
            continue
        lean = None
        if hoisted_bytes(int(np.prod(xs[1].shape[:2])), n_reps, B,
                         S_T.dtype.itemsize):
            lean = _precompute_lean(W, xs, S_T, a_T)
        if not relax_tol:
            for _ in range(n_reps):
                if lean is not None:
                    I = _run_hoisted_lap(W, passes, I, lean)
                else:
                    I = _run_stage(W, passes, I, xs, S_T, a_T)
            continue
        # adaptive exit: two consecutive sub-tol laps end the repeats
        # (a single stalled-but-unconverged lap must not truncate the
        # schedule); one scalar readback per lap.
        streak = 0
        for _ in range(n_reps):
            if lean is not None:
                I, rel = _run_hoisted_lap_d(W, passes, I, lean)
            else:
                I, rel = _run_relax_lap(W, passes, I, xs, S_T, a_T)
            streak = streak + 1 if float(rel) <= relax_tol else 0
            if streak >= 2:
                break

    return _finish(I, site_gather)


def sweep_voronoi_t(plan, S_T, a_T, I0, n_sweeps=3, relax_tol=0.0):
    """sweep_voronoi on pre-transposed (n, B) fields.

    The production entry point: callers that sweep many directions per
    lambda chunk transpose S once and each direction's extinction once,
    so no (B, n) -> (n, B) copies happen inside the per-direction
    executions.  Returns I as (n, B)."""
    sp = build_slot_plan(plan, n_sweeps)
    if I0.shape[-1] < sp.n_bc:      # bucketed bc block: pad writes zeros
        I0 = jnp.pad(I0, ((0, 0), (0, sp.n_bc - I0.shape[-1])))
    stage_arrays, site_gather, n_slots = _device_arrays(sp)
    shapes = (n_slots,
              tuple((st.kind, st.W, st.passes) for st in sp.stages))
    return _sweep_slots(shapes, float(relax_tol), stage_arrays,
                        site_gather, S_T, a_T, I0)


def sweep_voronoi(plan, S, alpha, I0, n_sweeps=3, relax_tol=0.0):
    """Formal solution over the irregular grid along plan.k.

    Args:
      plan: VoronoiPlan (static geometry for one direction).
      S, alpha: (B, n) or (n,) source function / extinction.
      I0: (B, n_bc) or (n_bc,) boundary intensity on plan.bc_sites
          (bottom-layer sites for up sweeps: lambda_iteration.jl:99-102).
      relax_tol: early-exit tolerance for seam-wrap relax repeats
          ('wavefront' plans); 0 = fixed repeat count (bitwise default).
    Returns:
      I with the shape of S.
    """
    squeeze = S.ndim == 1
    if squeeze:
        S, alpha, I0 = S[None], alpha[None], I0[None]
    I_T = sweep_voronoi_t(plan, S.T, alpha.T, I0, n_sweeps=n_sweeps,
                          relax_tol=relax_tol)
    I = I_T.T
    return I[0] if squeeze else I
