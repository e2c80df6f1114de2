"""Voronoi-grid sweep tests: regular-grid-identity, analytic slab,
searchlight beam translation (SURVEY.md §4.3)."""

import numpy as np
import pytest

from voronoirt_tpu.grid import build_sites, build_voronoi_plan
from voronoirt_tpu.solvers.sweep_voronoi import sweep_voronoi


def kvec(theta_deg, phi_deg):
    t, p = np.deg2rad(theta_deg), np.deg2rad(phi_deg)
    return np.array([np.cos(t), np.cos(p) * np.sin(t), np.sin(p) * np.sin(t)])


def _fields(n):
    return dict(temperature=np.ones(n), electron_density=np.zeros(n),
                hydrogen_populations=np.zeros(n), velocity_z=np.zeros(n),
                velocity_x=np.zeros(n), velocity_y=np.zeros(n))


def _skipped_site(sites, up=True):
    """Site the reference never updates under 'layer' ordering: the last
    entry of the sweep permutation (docs/PARITY.md item 3), reproduced by
    build_voronoi_plan when compat='reference'."""
    layers = sites.layers_up if up else sites.layers_down
    return int(np.nonzero(layers == layers.max())[0][-1])


def _grid_sites(m, lo=0.0, hi=1.0, jitter=0.0, seed=0):
    """Sites on (or near) regular grid points, cell-centred."""
    rng = np.random.default_rng(seed)
    ax = (np.arange(m) + 0.5) / m * (hi - lo) + lo
    Z, X, Y = np.meshgrid(ax, ax, ax, indexing="ij")
    pos = np.stack([Z.ravel(), X.ravel(), Y.ravel()], axis=1)
    if jitter:
        pos += rng.uniform(-jitter, jitter, pos.shape) * (hi - lo) / m
        pos[:, 0] = np.clip(pos[:, 0], lo + 1e-6, hi - 1e-6)
        pos[:, 1:] = (pos[:, 1:] - lo) % (hi - lo) + lo
    return pos, ax


class TestRegularIdentity:
    """Sites exactly on grid points must reproduce the regular-grid
    vertical two-point scheme (compare_continuum.jl:327-446
    test_with_regular_grid)."""

    def test_vertical_homogeneous_slab(self):
        m = 8
        pos, ax = _grid_sites(m)
        n = len(pos)
        sites = build_sites(pos, (0, 1, 0, 1, 0, 1), _fields(n))
        # layers: bottom plane = layer 1, etc.
        assert sites.layers_up.max() == m
        iz_of = np.round(pos[:, 0] * m - 0.5).astype(int)
        assert np.array_equal(sites.layers_up, iz_of + 1)

        a0, S0, Iin = 2.5, 1.3, 0.6
        S = np.full(n, S0)
        alpha = np.full(n, a0)
        k = kvec(180.0, 0.0)
        plan = build_voronoi_plan(sites, k, up=True)
        I0 = np.full(len(plan.bc_sites), Iin)
        I = np.asarray(sweep_voronoi(plan, S, alpha, I0))

        # expected: two-point scheme along the vertical site chain with
        # spacing dz = 1/m; layer 1 keeps I = I0 (boundary)
        dz = 1.0 / m
        expected = np.empty(m)
        expected[0] = Iin
        from voronoirt_tpu.solvers.formal import linear_weights
        aw, bw, ew = (float(v) for v in linear_weights(a0 * dz))
        for i in range(1, m):
            expected[i] = ew * expected[i - 1] + (aw + bw) * S0
        skipped = _skipped_site(sites)
        assert I[skipped] == 0.0  # reference's last-perm-site skip
        for iz in range(m):
            got = I[(iz_of == iz) & (np.arange(n) != skipped)]
            assert np.allclose(got, expected[iz], rtol=1e-10), f"layer {iz}"

    def test_oblique_on_jittered_grid_bounded(self):
        """Slightly jittered grid, oblique ray: result stays within the
        physical bracket [min(I0,S), max(I0,S)] and is finite."""
        m = 7
        pos, _ = _grid_sites(m, jitter=0.2, seed=3)
        n = len(pos)
        sites = build_sites(pos, (0, 1, 0, 1, 0, 1), _fields(n))
        S = np.full(n, 2.0)
        alpha = np.full(n, 1.0)
        k = kvec(150.0, 40.0)
        plan = build_voronoi_plan(sites, k, up=True)
        I0 = np.full(len(plan.bc_sites), 0.5)
        I = np.asarray(sweep_voronoi(plan, S, alpha, I0))
        assert np.all(np.isfinite(I))
        skipped = _skipped_site(sites)
        assert I[skipped] == 0.0  # reference's last-perm-site skip
        live = np.arange(n) != skipped
        assert I[live].min() >= 0.5 - 1e-9 and I[live].max() <= 2.0 + 1e-9


class TestSearchlightIrregular:
    """Beam translation through random sites (compare_searchlight.jl:10-152):
    flux approximately conserved, beam centroid at the analytic position."""

    @pytest.mark.parametrize("theta,phi,up", [(160.0, 45.0, True),
                                              (20.0, 15.0, False)])
    def test_beam(self, theta, phi, up):
        rng = np.random.default_rng(1998)
        n = 17 ** 3
        pos = rng.uniform(0, 1, (n, 3))
        sites = build_sites(pos, (0, 1, 0, 1, 0, 1), _fields(n))
        k = kvec(theta, phi)
        plan = build_voronoi_plan(sites, k, up=up)
        S = np.zeros(n)
        alpha = np.zeros(n)
        bc_pos = pos[plan.bc_sites]
        R0 = 0.22
        I0 = (np.hypot(bc_pos[:, 1] - 0.5, bc_pos[:, 2] - 0.5)
              < R0).astype(float)
        I = np.asarray(sweep_voronoi(plan, S, alpha, I0))

        # output layer = boundary layer of the opposite sweep
        layers_out = sites.layers_down if up else sites.layers_up
        out_sites = np.nonzero(layers_out == 1)[0]
        Iout = I[out_sites]
        pout = pos[out_sites]

        # flux conservation within the diffusive tolerance of the scheme
        flux_in = I0.mean() * len(plan.bc_sites)
        # compare beam areas via mean intensity (both layers sample the
        # full xy cross-section uniformly)
        assert Iout.mean() == pytest.approx(I0.mean(), rel=0.25)

        # circular-mean centroid vs analytic translated position
        xr = (0.5 - np.sign(k[0]) * k[1] / k[0]) % 1.0
        yr = (0.5 - np.sign(k[0]) * k[2] / k[0]) % 1.0
        w = Iout / Iout.sum()
        cx = np.angle(np.sum(w * np.exp(2j * np.pi * pout[:, 1]))) \
            / (2 * np.pi) % 1.0
        cy = np.angle(np.sum(w * np.exp(2j * np.pi * pout[:, 2]))) \
            / (2 * np.pi) % 1.0
        assert abs((cx - xr + 0.5) % 1.0 - 0.5) < 0.08
        assert abs((cy - yr + 0.5) % 1.0 - 0.5) < 0.08

class TestWavefrontOrder:
    """order='wavefront': exact topological levels over the upwind DAG
    (one pass per level) + s-binned relaxation for seam-wrapping chains.
    Fixes the grazing-angle beam loss inherent to the reference's fixed
    3-sweep BFS-layer scheme (irregular_ray_tracing.jl:37-79)."""

    def _sites(self, n=17 ** 3, seed=1998):
        rng = np.random.default_rng(seed)
        pos = rng.uniform(0, 1, (n, 3))
        return build_sites(pos, (0, 1, 0, 1, 0, 1), _fields(n)), pos

    def test_steep_angle_is_exact_fixed_point(self):
        """With no seam cycles the wavefront sweep solves the per-site
        two-point equations exactly in a single pass."""
        import jax.numpy as jnp
        from voronoirt_tpu.solvers.formal import linear_weights

        sites, _ = self._sites()
        n = sites.n
        rng = np.random.default_rng(7)
        S = rng.uniform(0.1, 1.0, n)
        alpha = rng.uniform(0.0, 2.0, n)
        plan = build_voronoi_plan(sites, kvec(160.0, 45.0), up=True,
                                  order="wavefront")
        assert plan.exact_levels is not None and plan.relax_levels is None
        I0 = rng.uniform(0.0, 1.0, len(plan.bc_sites))
        I = np.asarray(sweep_voronoi(plan, S, alpha, I0))

        up, w, r = plan.upwind, plan.weights, plan.r
        dtau = r * (alpha[:, None] + alpha[up]) * 0.5
        aw, bw, ew = (np.asarray(v) for v in
                      linear_weights(jnp.asarray(dtau)))
        rhs = (w * (ew * I[up] + aw * S[up] + bw * S[:, None])).sum(1)
        mask = np.ones(n, bool)
        mask[plan.bc_sites] = False
        assert np.abs(I - rhs)[mask].max() < 1e-10

    def test_grazing_beam_conserved(self):
        """theta=100.2deg: the layer scheme loses the whole beam; the
        wavefront scheme reaches the global fixed point."""
        sites, pos = self._sites()
        n = sites.n
        k = kvec(100.2, 15.0)
        plan_l = build_voronoi_plan(sites, k, up=True)
        plan_w = build_voronoi_plan(sites, k, up=True, order="wavefront")
        S = np.zeros(n)
        alpha = np.zeros(n)
        bc_pos = pos[plan_l.bc_sites]
        I0 = (np.hypot(bc_pos[:, 1] - 0.5, bc_pos[:, 2] - 0.5)
              < 0.25).astype(float)
        out = sites.layers_down == 1
        I_l = np.asarray(sweep_voronoi(plan_l, S, alpha, I0))
        I_w = np.asarray(sweep_voronoi(plan_w, S, alpha, I0))
        assert I_l[out].mean() < 0.02 * I0.mean()      # the failure mode
        assert I_w[out].mean() == pytest.approx(I0.mean(), rel=0.35)

        # ... and the wavefront result is the true fixed point: global
        # Jacobi iteration to convergence gives the same answer
        import jax.numpy as jnp
        from voronoirt_tpu.solvers.formal import linear_weights
        up, w, r = plan_w.upwind, plan_w.weights, plan_w.r
        dtau = r * (alpha[:, None] + alpha[up]) * 0.5
        aw, bw, ew = (np.asarray(v) for v in
                      linear_weights(jnp.asarray(dtau)))
        I = np.zeros(n)
        I[plan_w.bc_sites] = I0
        mask = np.ones(n, bool)
        mask[plan_w.bc_sites] = False
        for _ in range(2000):
            rhs = (w * (ew * I[up] + aw * S[up] + bw * S[:, None])).sum(1)
            I[mask] = rhs[mask]
        assert I_w[out].mean() == pytest.approx(I[out].mean(), rel=0.02)

    def test_regular_identity_matches_layer_mode(self):
        """Grid-aligned sites, vertical ray: both orderings reduce to the
        exact vertical chain."""
        m = 6
        pos, _ = _grid_sites(m)
        n = len(pos)
        sites = build_sites(pos, (0, 1, 0, 1, 0, 1), _fields(n))
        rng = np.random.default_rng(0)
        S = rng.uniform(0.5, 1.5, n)
        alpha = np.full(n, 1.7)
        k = kvec(180.0, 0.0)
        pl = build_voronoi_plan(sites, k, up=True)
        pw = build_voronoi_plan(sites, k, up=True, order="wavefront")
        I0 = rng.uniform(0.2, 0.9, len(pl.bc_sites))
        I_l = np.asarray(sweep_voronoi(pl, S, alpha, I0))
        I_w = np.asarray(sweep_voronoi(pw, S, alpha, I0))
        # layer mode under compat='reference' zeroes the last perm site
        skipped = _skipped_site(sites)
        assert I_l[skipped] == 0.0
        live = np.arange(n) != skipped
        assert np.allclose(I_l[live], I_w[live], rtol=1e-12)

    def test_batched_matches_single_wavefront(self):
        rng = np.random.default_rng(5)
        n = 500
        pos = rng.uniform(0, 1, (n, 3))
        sites = build_sites(pos, (0, 1, 0, 1, 0, 1), _fields(n))
        plan = build_voronoi_plan(sites, kvec(115.0, 200.0), up=True,
                                  order="wavefront")
        B = 3
        S = rng.uniform(0.1, 1.0, (B, n))
        alpha = rng.uniform(0.0, 3.0, (B, n))
        I0 = rng.uniform(0.0, 1.0, (B, len(plan.bc_sites)))
        I = np.asarray(sweep_voronoi(plan, S, alpha, I0))
        for b in range(B):
            Ib = np.asarray(sweep_voronoi(plan, S[b], alpha[b], I0[b]))
            assert np.allclose(I[b], Ib, rtol=1e-12)


class TestSearchlightBatched:
    def test_batched_matches_single(self):
        rng = np.random.default_rng(5)
        n = 500
        pos = rng.uniform(0, 1, (n, 3))
        sites = build_sites(pos, (0, 1, 0, 1, 0, 1), _fields(n))
        plan = build_voronoi_plan(sites, kvec(135.0, 200.0), up=True)
        B = 4
        S = rng.uniform(0.1, 1.0, (B, n))
        alpha = rng.uniform(0.0, 3.0, (B, n))
        I0 = rng.uniform(0.0, 1.0, (B, len(plan.bc_sites)))
        I = np.asarray(sweep_voronoi(plan, S, alpha, I0))
        for b in range(B):
            Ib = np.asarray(sweep_voronoi(plan, S[b], alpha[b], I0[b]))
            assert np.allclose(I[b], Ib, rtol=1e-12)


class TestGrazingWarning:
    """build_voronoi_plan warns when 'layer' ordering will truncate a
    grazing direction (docs/PARITY.md item 2 decision)."""

    def test_layer_grazing_warns(self):
        import warnings
        from voronoirt_tpu.grid.voronoi import GrazingLayerOrderWarning
        pos, _ = _grid_sites(5, jitter=0.3, seed=3)
        sites = build_sites(pos, (0, 1, 0, 1, 0, 1), _fields(len(pos)))
        with pytest.warns(GrazingLayerOrderWarning):
            build_voronoi_plan(sites, kvec(100.0, 30.0), up=True)
        # near-vertical and wavefront ordering stay silent
        with warnings.catch_warnings():
            warnings.simplefilter("error", GrazingLayerOrderWarning)
            build_voronoi_plan(sites, kvec(170.0, 30.0), up=True)
            build_voronoi_plan(sites, kvec(100.0, 30.0), up=True,
                               order="wavefront")


class TestGsScheduleVectorized:
    """The vectorized _gs_layer_schedule must reproduce the pure-Python
    oracle array-for-array (same rows, same columns, same occurrence
    targets) -- it is the parity-mode scheduler, so any deviation would
    silently change compat='reference' results."""

    @pytest.mark.parametrize("seed,theta,phi,up", [
        (0, 160.0, 45.0, True),
        (1, 20.0, 15.0, False),
        (2, 95.0, 200.0, True),     # grazing: deep in-layer chains
        (3, 120.0, 330.0, False),
    ])
    def test_matches_python_oracle(self, seed, theta, phi, up):
        from voronoirt_tpu.grid.voronoi import (_gs_layer_schedule,
                                                _gs_layer_schedule_py)
        rng = np.random.default_rng(seed)
        n = 800
        pos = np.column_stack([rng.uniform(0, 1, n) for _ in range(3)])
        sites = build_sites(pos, (0, 1, 0, 1, 0, 1), _fields(n))
        k = kvec(theta, phi)
        # raw ingredients exactly as build_voronoi_plan prepares them
        import warnings as _w
        with _w.catch_warnings():
            _w.simplefilter("ignore")
            plan = build_voronoi_plan(sites, k, up=up, order="layer")
        layer_lists = [row[row < sites.n] for row in plan.layer_sites]
        active = plan.weights > 0.0
        got = _gs_layer_schedule(layer_lists, plan.upwind, active,
                                 sites.n, 3, up)
        want = _gs_layer_schedule_py(layer_lists, plan.upwind, active,
                                     sites.n, 3, up)
        assert got[0].shape == want[0].shape
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1], want[1])

    def test_empty(self):
        from voronoirt_tpu.grid.voronoi import (_gs_layer_schedule,
                                                _gs_layer_schedule_py)
        upwind = np.zeros((4, 2), dtype=np.int32)
        active = np.zeros((4, 2), dtype=bool)
        got = _gs_layer_schedule([], upwind, active, 4, 3, True)
        want = _gs_layer_schedule_py([], upwind, active, 4, 3, True)
        assert got[0].shape == want[0].shape == (0, 1)
        assert got[1].shape == want[1].shape == (0, 1, 2)


class TestGrazingWithOpacity:
    """VERDICT round-2 ask: the wavefront relax schedule's repeat cap
    and bin width are calibrated on zero-opacity searchlights; verify a
    tau~1 slanted beam at the ul7n12 grazing angles also reaches the
    per-site fixed point within relax_repeats on a large box."""

    @pytest.mark.parametrize("up", [True, False])
    def test_tau1_grazing_fixed_point(self, up):
        import jax.numpy as jnp
        from voronoirt_tpu.config import Config
        from voronoirt_tpu.quadrature import get_quadrature
        from voronoirt_tpu.solvers.formal import linear_weights

        quad = get_quadrature("ul7n12")
        mus = np.abs(np.asarray(quad.k)[:, 0])
        cand = np.nonzero(np.asarray(quad.is_up) == up)[0]
        i = cand[np.argmin(mus[cand])]          # most grazing direction
        k = np.asarray(quad.k[i])
        assert abs(k[0]) < 0.45                 # genuinely grazing

        rng = np.random.default_rng(77)
        n = 25 ** 3
        pos = rng.uniform(0, 1, (n, 3))
        sites = build_sites(pos, (0, 1, 0, 1, 0, 1), _fields(n))
        plan = build_voronoi_plan(sites, k, up=up, order="wavefront")
        assert plan.relax_levels is not None    # wrap chains present

        S = rng.uniform(0.1, 1.0, n)
        alpha = np.full(n, 1.0)                 # tau ~ 1 across the box
        I0 = rng.uniform(0.5, 1.0, len(plan.bc_sites))
        cfg = Config()
        I = np.asarray(sweep_voronoi(plan, S, alpha, I0,
                                     relax_tol=cfg.voronoi_relax_tol))

        up_idx, w, r = plan.upwind, plan.weights, plan.r
        dtau = r * (alpha[:, None] + alpha[up_idx]) * 0.5
        aw, bw, ew = (np.asarray(v) for v in
                      linear_weights(jnp.asarray(dtau)))
        rhs = (w * (ew * I[up_idx] + aw * S[up_idx]
                    + bw * S[:, None])).sum(1)
        mask = np.ones(n, bool)
        mask[plan.bc_sites] = False
        resid = np.abs(I - rhs)[mask].max() / max(np.abs(I).max(), 1e-30)
        assert resid < 1e-6, f"grazing tau~1 residual {resid:.3e}"


class TestShapeBucketing:
    """build_slot_plan(bucket=True), the default, pads the bc block,
    stage (L, W) and total slot count up to a coarse power-of-two grid
    so the 12 quadrature directions share compiled sweeps (the 442k
    production bench spent 1341 of 1519 s in 12 per-direction
    compiles).  Pad rows read the dummy zero slot with weight zero and
    write zeros to pad slots, so real-site results must be BITWISE
    identical to the unbucketed layout."""

    @staticmethod
    def _sweep(plan, S, alpha, I0, bucket, relax_tol=0.0):
        import jax.numpy as jnp
        from voronoirt_tpu.solvers.sweep_voronoi import (
            _device_arrays, _sweep_slots, build_slot_plan)
        sp = build_slot_plan(plan, 3, bucket=bucket)
        S2 = jnp.asarray(S[:, None])
        a2 = jnp.asarray(alpha[:, None])
        I02 = jnp.asarray(I0[None])
        if I02.shape[-1] < sp.n_bc:
            I02 = jnp.pad(I02, ((0, 0), (0, sp.n_bc - I02.shape[-1])))
        sa, tg, n_slots = _device_arrays(sp)
        shapes = (n_slots,
                  tuple((st.kind, st.W, st.passes) for st in sp.stages))
        return np.asarray(
            _sweep_slots(shapes, relax_tol, sa, tg, S2, a2, I02))[:, 0]

    @pytest.mark.parametrize("order,theta", [
        ("layer", 160.0),        # gs stage (compat exact Gauss-Seidel)
        ("wavefront", 160.0),    # exact stage only
        ("wavefront", 100.2),    # exact + relax (seam-wrap repeats)
    ])
    def test_bitwise_vs_unbucketed(self, order, theta):
        rng = np.random.default_rng(11)
        n = 15 ** 3
        pos = rng.uniform(0, 1, (n, 3))
        sites = build_sites(pos, (0, 1, 0, 1, 0, 1), _fields(n))
        import warnings as _w
        with _w.catch_warnings():
            _w.simplefilter("ignore")
            plan = build_voronoi_plan(sites, kvec(theta, 35.0), up=True,
                                      order=order)
        S = rng.uniform(0.1, 1.0, n)
        alpha = rng.uniform(0.0, 2.0, n)
        I0 = rng.uniform(0.0, 1.0, len(plan.bc_sites))
        a = self._sweep(plan, S, alpha, I0, bucket=False)
        b = self._sweep(plan, S, alpha, I0, bucket=True)
        assert np.array_equal(a, b)          # bitwise

    def test_quadrature_directions_share_signatures(self):
        """share_plan_shapes pads every direction in a stage-structure
        group to the group max, so the jit cache key (static shapes +
        array shapes) is IDENTICAL within each group: the 12 ul7n12
        directions need one compile per group instead of 12."""
        from voronoirt_tpu.quadrature import get_quadrature
        from voronoirt_tpu.solvers.sweep_voronoi import (
            build_slot_plan, share_plan_shapes)

        rng = np.random.default_rng(1998)
        n = 17 ** 3
        pos = rng.uniform(0, 1, (n, 3))
        sites = build_sites(pos, (0, 1, 0, 1, 0, 1), _fields(n))
        quad = get_quadrature("ul7n12")

        plans = [build_voronoi_plan(sites, np.asarray(quad.k[i]),
                                    up=bool(quad.is_up[i]),
                                    order="wavefront")
                 for i in range(quad.n_angles)]

        def sigs():
            out = set()
            for plan in plans:
                sp = build_slot_plan(plan, 3)
                out.add((tuple((st.kind, st.L, st.W, st.passes)
                                for st in sp.stages),
                         sp.n_slots, sp.n_bc))
            return out

        raw = sigs()
        # unshared: per-direction shapes differ (opportunistic
        # bucketing collapses some but not all at this small scale)
        share_plan_shapes(plans, 3)
        shared = sigs()
        # members cluster by (stage kinds, bucketed widths): every
        # cluster shares exactly one signature, and the padding per
        # member stays bounded by the cluster width bucket
        assert len(shared) < len(raw)
        assert len(shared) <= 6
        for p in plans:
            sp = build_slot_plan(p, 3)
            raw_sp = build_slot_plan(p, 3, bucket=False)
            assert sp.n_slots <= 1.45 * raw_sp.n_slots

    def test_shared_shapes_bitwise(self):
        """Sweeps through share_plan_shapes-padded plans equal the
        unpadded per-direction results bitwise."""
        from voronoirt_tpu.quadrature import get_quadrature
        from voronoirt_tpu.solvers.sweep_voronoi import share_plan_shapes

        rng = np.random.default_rng(4)
        n = 13 ** 3
        pos = rng.uniform(0, 1, (n, 3))
        sites = build_sites(pos, (0, 1, 0, 1, 0, 1), _fields(n))
        quad = get_quadrature("ul2n3")
        plans = [build_voronoi_plan(sites, np.asarray(quad.k[i]),
                                    up=bool(quad.is_up[i]),
                                    order="wavefront")
                 for i in range(quad.n_angles)]
        S = rng.uniform(0.1, 1.0, n)
        alpha = rng.uniform(0.0, 2.0, n)
        I0s = [rng.uniform(0.0, 1.0, len(p.bc_sites)) for p in plans]
        before = [np.asarray(sweep_voronoi(p, S, alpha, I0))
                  for p, I0 in zip(plans, I0s)]
        share_plan_shapes(plans, 3)
        after = [np.asarray(sweep_voronoi(p, S, alpha, I0))
                 for p, I0 in zip(plans, I0s)]
        for a, b in zip(before, after):
            assert np.array_equal(a, b)


class TestAdaptiveRelaxExit:
    """The adaptive relax exit (relax_tol > 0) measures the EXACT lap
    sup-change inside the level scan (round 5: old rows are read before
    each level's update -- no strided sampling).  Ending early must not
    change the answer beyond the tolerance: compare against the full
    fixed-repeat schedule (relax_tol=0, the bitwise reference)."""

    @pytest.mark.parametrize("theta", [100.2, 79.8])
    def test_adaptive_matches_fixed_repeats(self, theta):
        rng = np.random.default_rng(23)
        n = 17 ** 3
        pos = rng.uniform(0, 1, (n, 3))
        sites = build_sites(pos, (0, 1, 0, 1, 0, 1), _fields(n))
        plan = build_voronoi_plan(sites, kvec(theta, 55.0), up=True,
                                  order="wavefront")
        assert plan.relax_levels is not None and plan.relax_repeats > 1
        S = rng.uniform(0.1, 1.0, n)
        alpha = rng.uniform(0.0, 2.0, n)
        I0 = rng.uniform(0.2, 1.0, len(plan.bc_sites))
        tol = 1e-7
        I_fix = np.asarray(sweep_voronoi(plan, S, alpha, I0,
                                         relax_tol=0.0))
        I_ad = np.asarray(sweep_voronoi(plan, S, alpha, I0,
                                        relax_tol=tol))
        scale = max(np.abs(I_fix).max(), 1e-30)
        # two consecutive sub-tol laps end the repeats; the remaining
        # drift is bounded by ~n_skipped_laps * tol * scale
        assert np.abs(I_ad - I_fix).max() / scale < 64 * tol


def test_float64_sweep_after_float32_keeps_float64_geometry():
    """A plan swept in float32 and then in float64 in one process gives
    the float64 sweep of a fresh plan bitwise: the device geometry
    (weights, path lengths) is kept per x64 mode, not reused rounded."""
    import jax
    pos, _ = _grid_sites(6, jitter=0.2, seed=4)
    n = len(pos)
    sites = build_sites(pos, (0, 1, 0, 1, 0, 1), _fields(n))
    k = kvec(150.0, 40.0)
    rng = np.random.default_rng(0)
    S, alpha = rng.uniform(0.5, 2.0, n), rng.uniform(0.5, 3.0, n)
    plan = build_voronoi_plan(sites, k, up=True, order="wavefront")
    I0 = np.full(len(plan.bc_sites), 0.7)
    jax.config.update("jax_enable_x64", False)
    try:
        sweep_voronoi(plan, S.astype(np.float32), alpha.astype(np.float32),
                      I0.astype(np.float32))
    finally:
        jax.config.update("jax_enable_x64", True)
    got = np.asarray(sweep_voronoi(plan, S, alpha, I0))
    fresh = build_voronoi_plan(sites, k, up=True, order="wavefront")
    np.testing.assert_array_equal(
        got, np.asarray(sweep_voronoi(fresh, S, alpha, I0)))
