"""Regular-grid sweep tests: oracle fixtures, published golden, physics
acceptance (searchlight beam test, SURVEY.md §4.3)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from voronoirt_tpu.solvers.sweep_regular import (build_plan,
                                                 short_characteristics)

FIX = os.path.join(os.path.dirname(__file__), "golden",
                   "regular_sweep_fixtures.npz")
REF_GOLD = "/root/reference/data/searchlight_data"

needs_ref = pytest.mark.skipif(
    not os.path.isdir(REF_GOLD), reason="reference goldens not available")


def kvec(theta_deg, phi_deg):
    t, p = np.deg2rad(theta_deg), np.deg2rad(phi_deg)
    return np.array([np.cos(t), np.cos(p) * np.sin(t), np.sin(p) * np.sin(t)])


class TestOracleFixtures:
    """Field-exact comparison against the characteristics.jl oracle."""

    @pytest.mark.parametrize("case", ["up_xy", "dn_xy", "up_yz", "dn_yz",
                                      "up_xz", "dn_xz", "up_mix", "dn_mix"])
    def test_matches_oracle(self, case):
        fx = np.load(FIX)
        k = fx[f"{case}_k"]
        z = fx[f"{case}_z"]
        S = fx[f"{case}_S"]
        alpha = fx[f"{case}_alpha"]
        I0 = fx[f"{case}_I0"]
        expected = fx[f"{case}_I"]
        up = bool(fx[f"{case}_up"])
        dx = 1.0 / S.shape[1]
        I = np.asarray(short_characteristics(k, S, alpha, I0, z, dx, dx,
                                             up=up, n_sweeps=3))
        err = np.max(np.abs(I - expected) / (np.abs(expected) + 1e-12))
        assert err < 1e-12, f"{case}: max rel err {err}"


def _beam_I0(n, R0=0.1):
    """Reference beam mask (compare_searchlight.jl:182-190): xi = i/n,
    1-based."""
    I0 = np.zeros((n, n))
    for i in range(n):
        for j in range(n):
            xi, yi = (i + 1) / n, (j + 1) / n
            if np.hypot(xi - 0.5, yi - 0.5) < R0:
                I0[i, j] = 1.0
    return I0


class TestSearchlight:
    """Physics acceptance: zero-opacity beam translation (the reference's
    #1 correctness fixture, compare_searchlight.jl:154-225)."""

    def _run(self, theta, phi, n=51):
        k = kvec(theta, phi)
        up = theta > 90
        ax = np.linspace(0, 1, n)
        # physical periodic domain = reference's interior columns 2:n-1
        phys = slice(1, n - 1)
        S = np.zeros((n, n - 2, n - 2))
        alpha = np.zeros_like(S)
        I0 = _beam_I0(n)[phys, phys]
        dx = ax[1] - ax[0]
        I = np.asarray(short_characteristics(k, S, alpha, I0, ax, dx, dx,
                                             up=up, n_sweeps=3))
        return I[-1] if up else I[0], ax[phys], I0

    @needs_ref
    def test_up_golden_160_45(self):
        """Exact match to the published golden image."""
        img, _, _ = self._run(160.0, 45.0)
        gold = np.load(os.path.join(REF_GOLD, "I_160_45_regular.npy"))
        assert img.shape == gold.shape == (49, 49)
        assert np.max(np.abs(img - gold)) < 1e-12
        assert img.sum() == pytest.approx(80.0, abs=1e-9)

    def test_down_flux_and_position(self):
        """Down sweep: flux conserved, beam at the analytic position
        (plot_utils.jl:35-47); see tests/golden/README.md for why the
        stored 20_15 file is not used directly."""
        theta, phi = 20.0, 15.0
        img, x, I0 = self._run(theta, phi)
        assert img.sum() == pytest.approx(I0.sum(), rel=1e-9)
        k = kvec(theta, phi)
        xr = (0.5 - np.sign(k[0]) * k[1] / k[0]) % 1.0
        yr = (0.5 - np.sign(k[0]) * k[2] / k[0]) % 1.0
        X, Y = np.meshgrid(x, x, indexing="ij")
        w = img / img.sum()
        # wrap-aware centroid via circular mean
        cx = np.angle(np.sum(w * np.exp(2j * np.pi * X))) / (2 * np.pi) % 1.0
        cy = np.angle(np.sum(w * np.exp(2j * np.pi * Y))) / (2 * np.pi) % 1.0
        assert abs(cx - xr) < 0.03
        assert abs(cy - yr) < 0.03

    def test_up_flux_all_quadrature_angles(self):
        """Flux conservation for all 12 production angles (hits every
        kernel case)."""
        from voronoirt_tpu.quadrature import get_quadrature
        quad = get_quadrature("ul7n12")
        n = 31
        ax = np.linspace(0, 1, n)
        S = np.zeros((n, n - 2, n - 2))
        alpha = np.zeros_like(S)
        I0 = _beam_I0(n)[1:-1, 1:-1]
        dx = ax[1] - ax[0]
        for i in range(quad.n_angles):
            k = quad.k[i]
            up = quad.is_up[i]
            I = np.asarray(short_characteristics(
                k, S, alpha, I0, ax, dx, dx, up=bool(up), n_sweeps=3))
            img = I[-1] if up else I[0]
            # n_sweeps=3 leaves a ~1e-7 periodic-wrap residual in the
            # marching cases (the reference behaves identically; its sum
            # converges to exactly I0.sum() at n_sweeps=6).
            assert img.sum() == pytest.approx(I0.sum(), rel=1e-6), \
                f"angle {i}: flux not conserved"


class TestAnalytic:
    def test_vertical_ray_homogeneous_slab(self):
        """Constant alpha & S, vertical ray: the two-point scheme is exact:
        I_top = I0 e^-tau + S (1 - e^-tau)."""
        n = 21
        nz = 40
        z = np.linspace(0.0, 1.0, nz)
        a0, S0, Iin = 3.0, 1.7, 0.4
        S = np.full((nz, n, n), S0)
        alpha = np.full((nz, n, n), a0)
        I0 = np.full((n, n), Iin)
        k = kvec(180.0, 0.0)  # straight up
        I = np.asarray(short_characteristics(k, S, alpha, I0, z, 1.0 / n,
                                             1.0 / n, up=True))
        tau = a0 * z
        expected = Iin * np.exp(-tau) + S0 * (1 - np.exp(-tau))
        got = I[:, 0, 0]
        assert np.allclose(got, expected, rtol=1e-10)

    def test_batch_axis(self):
        """(nz, B, Nx, Ny) batch matches per-slice runs."""
        rng = np.random.default_rng(0)
        nz, B, N = 8, 3, 6
        z = np.linspace(0, 1, nz)
        S = rng.uniform(0.1, 1.0, (nz, B, N, N))
        alpha = rng.uniform(0.0, 3.0, (nz, B, N, N))
        I0 = rng.uniform(0.0, 1.0, (B, N, N))
        k = kvec(150.0, 30.0)
        I = np.asarray(short_characteristics(k, S, alpha, I0, z, 1.0 / N,
                                             1.0 / N, up=True))
        for b in range(B):
            Ib = np.asarray(short_characteristics(
                k, S[:, b], alpha[:, b], I0[b], z, 1.0 / N, 1.0 / N,
                up=True))
            assert np.allclose(I[:, b], Ib, rtol=1e-12)


class TestBezierInterpolation:
    """Quadratic DELO-Bezier formal solution (formal.bezier_weights,
    sweep(..., interpolation='bezier')) -- the higher-order upgrade of
    BASELINE.json's north star; not present in the reference."""

    def test_weight_identities(self):
        from voronoirt_tpu.solvers.formal import bezier_weights
        dt = jnp.asarray(np.concatenate([np.logspace(-8, -1.4, 30),
                                         np.linspace(0.051, 49, 40),
                                         [55.0, 200.0]]))
        wu, wc, wk, E = (np.asarray(v) for v in bezier_weights(dt))
        dtn = np.asarray(dt)
        Eex = np.exp(-dtn)
        assert np.allclose(wu + wc + wk, 1.0 - Eex, atol=2e-9)
        # exact for S quadratic in tau with the exact control point
        sel = dtn > 0.05        # avoid cancellation in the test's own J2
        J0 = 1 - Eex
        J1 = dtn - J0
        J2 = dtn ** 2 - 2 * J1
        a, b, c = 0.7, -0.3, 1.1
        exact = (a * J0 + b * J1 + c * J2)[sel]
        got = (wu * a + wc * (a + b * dtn + c * dtn ** 2)
               + wk * (a + 0.5 * dtn * b))[sel]
        assert np.allclose(got, exact, rtol=1e-12)

    def test_control_point_monotone_and_quadratic_exact(self):
        from voronoirt_tpu.solvers.formal import bezier_control
        # monotone quadratic S(t) = 1 + 2 t + 0.5 t^2, nodes at -h1, 0, h2
        h1, h2 = 0.4, 0.3
        Sf = lambda t: 1.0 + 2.0 * t + 0.5 * t * t
        C = float(bezier_control(jnp.asarray(Sf(-h1)), jnp.asarray(Sf(0.0)),
                                 jnp.asarray(Sf(h2)), jnp.asarray(h1),
                                 jnp.asarray(h2)))
        assert C == pytest.approx(Sf(0.0) + 0.5 * h2 * 2.0, rel=1e-12)
        # extremum -> flat control point, C within [S_up, S_c]
        C2 = float(bezier_control(jnp.asarray(3.0), jnp.asarray(2.0),
                                  jnp.asarray(5.0), jnp.asarray(0.5),
                                  jnp.asarray(0.8)))
        assert C2 == pytest.approx(2.0)

    def test_column_accuracy_beats_linear(self):
        from voronoirt_tpu.solvers.sweep_regular import short_characteristics
        nz = 33
        z = np.linspace(0.0, 1.0, nz)
        a0 = 3.0
        Sf = lambda zz: 1.0 + np.sin(3 * zz)
        S = np.tile(Sf(z)[:, None, None], (1, 4, 4))
        alpha = np.full((nz, 4, 4), a0)
        I0 = np.zeros((4, 4))
        # exact: I(z) = int_0^z S a0 e^{-a0 (z - t)} dt (closed form)
        t = z
        Iex = ((1 - np.exp(-a0 * t))
               + a0 * (a0 * np.sin(3 * t) - 3 * np.cos(3 * t)
                       + 3 * np.exp(-a0 * t)) / (a0 * a0 + 9.0))
        k = np.array([-1.0, 0.0, 0.0])
        errs = {}
        for interp in ("linear", "bezier"):
            I = np.asarray(short_characteristics(
                k, jnp.asarray(S), jnp.asarray(alpha), jnp.asarray(I0),
                z, 1.0, 1.0, up=True, interpolation=interp))
            errs[interp] = np.abs(I[:, 0, 0] - Iex).max()
        assert errs["bezier"] < errs["linear"] / 3.0

    def test_oblique_bracket_and_finite(self):
        from voronoirt_tpu.solvers.sweep_regular import short_characteristics
        rng = np.random.default_rng(0)
        nz = 12
        z = np.linspace(0, 1, nz)
        S = rng.uniform(0.2, 1.0, (nz, 3, 8, 8))
        alpha = rng.uniform(0, 5, (nz, 3, 8, 8))
        I0 = rng.uniform(0, 1, (3, 8, 8))
        th = np.deg2rad(160.0)
        k = np.array([np.cos(th), np.cos(0.8) * np.sin(th),
                      np.sin(0.8) * np.sin(th)])
        I = np.asarray(short_characteristics(
            k, jnp.asarray(S), jnp.asarray(alpha), jnp.asarray(I0),
            z, 0.1, 0.1, up=True, interpolation="bezier"))
        assert np.isfinite(I).all()
        lo = min(S.min(), I0.min())
        hi = max(S.max(), I0.max())
        assert I.min() >= lo - 1e-12 and I.max() <= hi + 1e-12


class TestZFlipBatchedGroups:
    """Down sweeps z-flip-canonicalize into up sweeps (group_plans) and
    batch with them in one sweep_batched call.  The merge must be EXACT:
    the flip is an index permutation, every per-plane update is the same
    arithmetic, and the xz-down centre quirk (characteristics.jl:794,804)
    rides a 0/1 per-element blend."""

    def _fields(self, nz, nx, ny, B, seed):
        rng = np.random.default_rng(seed)
        S = jnp.asarray(rng.uniform(0.1, 1.0, (nz, B, nx, ny)))
        alpha = jnp.asarray(10.0 ** rng.uniform(-2, 1, (nz, B, nx, ny)))
        I0_up = jnp.asarray(rng.uniform(0.5, 1.0, (B, nx, ny)))
        I0_dn = jnp.zeros((B, nx, ny))
        return S, alpha, I0_up, I0_dn

    @pytest.mark.parametrize("theta_pair,phi", [
        ((100.0, 80.0), 30.0),    # xy case (steep)
        ((94.0, 86.0), 20.0),     # yz case (grazing, phi small -> x march)
        ((95.0, 85.0), 75.0),     # xz case (grazing, phi large -> y march)
    ])
    def test_mixed_up_down_group_matches_per_angle(self, theta_pair, phi):
        from voronoirt_tpu.solvers.sweep_regular import (flip_field,
                                                         group_plans,
                                                         sweep,
                                                         sweep_batched)
        nz, nx, ny, B = 12, 8, 8, 3
        dx = 1.0 / nx
        z = np.linspace(0.0, 1.0, nz)
        th_up, th_dn = theta_pair
        ks = [kvec(th_up, phi), kvec(th_dn, phi),
              kvec(th_up, phi + 180.0), kvec(th_dn, phi + 180.0)]
        ups = [True, False, True, False]
        groups = group_plans(ks, ups, z, dx, dx)
        merged = [g for g in groups if len(g) > 1]
        assert merged, "expected up/down angles to merge on uniform z"
        S, alpha, I0_up, I0_dn = self._fields(nz, nx, ny, B, seed=7)

        for g in merged:
            parts_S, parts_a, parts_I0 = [], [], []
            for (i, _, (fx, fy, fz)) in g:
                I0 = I0_dn if fz else I0_up
                parts_S.append(flip_field(S, fx, fy, fz))
                parts_a.append(flip_field(alpha, fx, fy, fz))
                parts_I0.append(flip_field(I0, fx, fy))
            I_b = sweep_batched(tuple(p for (_, p, _) in g),
                                jnp.concatenate(parts_S, axis=1),
                                jnp.concatenate(parts_a, axis=1),
                                jnp.concatenate(parts_I0, axis=0),
                                n_sweeps=3,
                                down_flags=tuple(f[2] for (_, _, f) in g))
            for e, (i, _, f) in enumerate(g):
                got = np.asarray(flip_field(I_b[:, e * B:(e + 1) * B], *f))
                from voronoirt_tpu.solvers.sweep_regular import build_plan
                plan_i = build_plan(ks[i], z, dx, dx, ups[i])
                I0 = I0_up if ups[i] else I0_dn
                want = np.asarray(sweep(plan_i, S, alpha, I0, n_sweeps=3))
                err = np.max(np.abs(got - want)
                             / (np.abs(want) + 1e-300))
                assert err < 1e-13, f"angle {i}: max rel err {err}"

    def test_nonuniform_z_grouping_still_exact(self):
        """Random (non-palindromic) z spacing: flipped-down signatures
        differ from up ones, so merging may not happen -- but whatever
        groups form must still reproduce the per-angle sweeps."""
        from voronoirt_tpu.solvers.sweep_regular import (build_plan,
                                                         flip_field,
                                                         group_plans,
                                                         sweep,
                                                         sweep_batched)
        rng = np.random.default_rng(11)
        nz, nx, ny, B = 10, 8, 8, 2
        dx = 1.0 / nx
        z = np.concatenate([[0.0], np.cumsum(rng.uniform(0.5, 2.0, nz - 1))])
        ks = [kvec(120.0, 40.0), kvec(60.0, 40.0),
              kvec(120.0, 220.0), kvec(60.0, 220.0)]
        ups = [True, False, True, False]
        groups = group_plans(ks, ups, z, dx, dx)
        S, alpha, I0_up, I0_dn = self._fields(nz, nx, ny, B, seed=13)
        for g in groups:
            if len(g) == 1:
                continue
            parts_S, parts_a, parts_I0 = [], [], []
            for (i, _, (fx, fy, fz)) in g:
                I0 = I0_dn if fz else I0_up
                parts_S.append(flip_field(S, fx, fy, fz))
                parts_a.append(flip_field(alpha, fx, fy, fz))
                parts_I0.append(flip_field(I0, fx, fy))
            I_b = sweep_batched(tuple(p for (_, p, _) in g),
                                jnp.concatenate(parts_S, axis=1),
                                jnp.concatenate(parts_a, axis=1),
                                jnp.concatenate(parts_I0, axis=0),
                                n_sweeps=3,
                                down_flags=tuple(f[2] for (_, _, f) in g))
            for e, (i, _, f) in enumerate(g):
                got = np.asarray(flip_field(I_b[:, e * B:(e + 1) * B], *f))
                plan_i = build_plan(ks[i], z, dx, dx, ups[i])
                I0 = I0_up if ups[i] else I0_dn
                want = np.asarray(sweep(plan_i, S, alpha, I0, n_sweeps=3))
                err = np.max(np.abs(got - want) / (np.abs(want) + 1e-300))
                assert err < 1e-13, f"angle {i}: max rel err {err}"
