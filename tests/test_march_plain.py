"""Plain marching (yz/xz) and xy plane updates of the regular sweep
against a numpy loop of the reference recurrence, and the choice and
plumbing of the CUDA march kernel (whose on-card check is marked gpu)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from voronoirt_tpu.solvers import sweep_regular as sr


def _weights(dtau):
    """Two-point linear formal-solution weights (functions.jl:484-500)."""
    if dtau < 5e-4:
        return (dtau * (0.5 - dtau / 3.0), dtau * (0.5 - dtau / 6.0),
                1.0 - dtau + 0.5 * dtau * dtau)
    if dtau > 50.0:
        a = 1.0 / dtau
        return a, 1.0 - a, 0.0
    e = np.exp(-dtau)
    a = (1.0 - e) / dtau - e
    return a, 1.0 - a - e, e


def _march_loop(a_p, a_c, s_p, s_c, i_p, sign, s_base, f, r, w_cur,
                n_sweeps, centre_prev):
    """characteristics.jl:420-483 (yz case, march over x) as loops:
    one line buffer per batch row, zeroed once, kept across passes."""
    B, N, M = a_c.shape
    order = range(N) if sign > 0 else range(N - 1, -1, -1)
    wp = 1.0 - w_cur
    a_ctr, s_ctr = (a_p, s_p) if centre_prev else (a_c, s_c)
    out = np.zeros_like(a_c)
    for b in range(B):
        buf = np.zeros(M)
        for p in range(n_sweeps):
            for ix in order:
                iu = (ix + sign) % N
                new = np.zeros(M)
                for y in range(M):
                    y0, y1 = (y + s_base) % M, (y + s_base + 1) % M
                    li = lambda v: (1.0 - f) * v[y0] + f * v[y1]
                    a_up = wp * li(a_p[b, iu]) + w_cur * li(a_c[b, iu])
                    s_up = wp * li(s_p[b, iu]) + w_cur * li(s_c[b, iu])
                    i_up = wp * li(i_p[b, iu]) + w_cur * li(buf)
                    aw, bw, ew = _weights(r * (a_ctr[b, ix, y] + a_up) / 2)
                    new[y] = ew * i_up + aw * s_up + bw * s_ctr[b, ix, y]
                buf = new
                if p == n_sweeps - 1:
                    out[b, ix] = new
    return out


def _plane_fields(seed, B=3, nx=6, ny=5):
    rng = np.random.default_rng(seed)
    mk = lambda lo, hi: rng.uniform(lo, hi, (B, nx, ny))
    return (mk(0.0, 2.0), mk(0.0, 2.0), mk(0.1, 1.0), mk(0.1, 1.0),
            mk(0.0, 1.0))


def _march_plan(sign, s_base, f_line, r):
    return sr.RegularPlan(k=(0, 0, 0), up=True, sign_x=sign, sign_y=0,
                          sxs=0, sys=s_base, r_x=r, r_y=0.0,
                          fy_line=f_line, fx_line=0.0, segments=())


@pytest.mark.parametrize("sign,s_base,f_line,centre_prev",
                         [(1, 0, 0.3, False), (-1, -1, 0.7, False),
                          (1, -1, 0.0, True), (-1, 0, 1.0, False)])
def test_march_plane_matches_loop(sign, s_base, f_line, centre_prev):
    a_p, a_c, s_p, s_c, i_p = _plane_fields(0)
    r, w_cur = 1.7, 0.35
    got = np.asarray(sr._march_plane(
        _march_plan(sign, s_base, f_line, r), "yz", 3, w_cur,
        jnp.asarray(i_p), jnp.asarray(a_c), jnp.asarray(a_p),
        jnp.asarray(s_c), jnp.asarray(s_p),
        "prev" if centre_prev else "cur"))
    want = _march_loop(a_p, a_c, s_p, s_c, i_p, sign, s_base, f_line, r,
                       w_cur, 3, centre_prev)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)


def _bilinear(A, x, y, sx, sy, fx, fy):
    nx, ny = A.shape
    x0, x1 = (x + sx) % nx, (x + sx + 1) % nx
    y0, y1 = (y + sy) % ny, (y + sy + 1) % ny
    return ((1 - fx) * ((1 - fy) * A[x0, y0] + fy * A[x0, y1])
            + fx * ((1 - fy) * A[x1, y0] + fy * A[x1, y1]))


@pytest.mark.parametrize("sxs,sys,fx,fy", [(0, 0, 0.3, 0.8),
                                           (-1, 0, 0.9, 0.2),
                                           (0, -1, 0.0, 1.0),
                                           (-1, -1, 0.5, 0.5)])
def test_xy_step_matches_loop(sxs, sys, fx, fy):
    a_p, a_c, s_p, s_c, i_p = _plane_fields(1, B=2, nx=5, ny=6)
    r = 1.3
    plan = sr.RegularPlan(k=(0, 0, 0), up=True, sign_x=1, sign_y=1,
                          sxs=sxs, sys=sys, r_x=0, r_y=0, fy_line=0,
                          fx_line=0, segments=())
    got, _ = sr._xy_step(plan, jnp.asarray(i_p),
                         (jnp.asarray(a_c), jnp.asarray(a_p),
                          jnp.asarray(s_c), jnp.asarray(s_p), r, fx, fy,
                          0.0))
    want = np.zeros_like(a_c)
    B, nx, ny = a_c.shape
    for b in range(B):
        for x in range(nx):
            for y in range(ny):
                up = lambda A: _bilinear(A[b], x, y, sxs, sys, fx, fy)
                aw, bw, ew = _weights(r * (a_c[b, x, y] + up(a_p)) / 2)
                want[b, x, y] = (ew * up(i_p) + aw * up(s_p)
                                 + bw * s_c[b, x, y])
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-12,
                               atol=1e-14)


def test_kernel_chosen_only_on_gpu_float32(monkeypatch):
    from voronoirt_tpu.solvers import march_cuda
    assert not march_cuda.kernel_selected(jnp.float32)  # CPU here
    monkeypatch.setattr(march_cuda.jax, "default_backend", lambda: "gpu")
    assert march_cuda.kernel_selected(jnp.float32)
    assert not march_cuda.kernel_selected(jnp.float64)


def test_kernel_inputs_shapes_and_per_row_f(monkeypatch):
    """With the kernel selected, _march_plane hands it (N, B, M) march-
    order coeff/const, the per-row f of a batched group and the stencil
    shift, and puts its lines back exactly like the plain path."""
    from voronoirt_tpu.solvers import march_cuda
    a_p, a_c, s_p, s_c, i_p = (jnp.asarray(a, jnp.float32)
                               for a in _plane_fields(2, B=4))
    plan = _march_plan(-1, -1, 0.0, 1.1)
    f = np.array([0.1, 0.2, 0.6, 0.9], np.float32)
    geom = {"f_line": jnp.asarray(f[:, None]),
            "r": jnp.full((4, 1), 1.1, jnp.float32)}
    seen = {}

    def fake(coeff, const, f_line, s_base, n_sweeps):
        rows = march_cuda.f_rows(f_line, const.shape[1], const.dtype)
        seen.update(shape=coeff.shape, const_shape=const.shape,
                    f=np.asarray(rows), s_base=s_base, n_sweeps=n_sweeps)
        return sr._march_scan(coeff, const, rows[:, None], s_base,
                              n_sweeps)

    args = (plan, "yz", 3, 0.35, i_p, a_c, a_p, s_c, s_p, "cur")
    want = np.asarray(sr._march_plane(*args, geom=geom))
    monkeypatch.setattr(march_cuda, "kernel_selected", lambda d: True)
    monkeypatch.setattr(march_cuda, "march_lines", fake)
    got = np.asarray(sr._march_plane(*args, geom=geom))
    assert seen["shape"] == seen["const_shape"] == (6, 4, 5)
    np.testing.assert_array_equal(seen["f"], f)
    assert (seen["s_base"], seen["n_sweeps"]) == (-1, 3)
    np.testing.assert_array_equal(got, want)


def _scan_recording(seen):
    """The plain scan as a stand-in for the kernel's per-device call,
    recording the operand shapes it is traced with."""
    def march(coeff, const, f, s_base, n_sweeps):
        seen.append(const.shape)
        return sr._march_scan(coeff, const, f[:, None], s_base, n_sweeps)
    return march


def test_kernel_call_partitioned_along_lines():
    """On a ("lam", "y") mesh the kernel call runs on each device's own
    lines (B / 2), whole along the march and line axes, inside a plane
    scan as in the sweep, and equals the unsharded march."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    from voronoirt_tpu.parallel import make_mesh
    from voronoirt_tpu.solvers import march_cuda
    seen = []
    march = march_cuda.line_partitioned(_scan_recording(seen))
    rng = np.random.default_rng(3)
    Z, N, B, M = 3, 6, 8, 4
    coeff = rng.uniform(0.0, 0.9, (Z, N, B, M))
    const = rng.uniform(0.0, 1.0, (Z, N, B, M))
    f = jnp.asarray(rng.uniform(0.0, 1.0, B))
    mesh = make_mesh((2, 2), ("lam", "y"))
    sh = NamedSharding(mesh, P(None, None, "lam", "y"))

    @jax.jit
    def planes(c, k):
        return jax.lax.scan(lambda _, ck: (None, march(*ck, f, -1, 3)),
                            None, (c, k))[1]

    got = planes(jax.device_put(coeff, sh), jax.device_put(const, sh))
    assert (N, B // 2, M) in seen and (N, B // 2, M // 2) not in seen
    want = np.stack([sr._march_scan(coeff[z], const[z], f[:, None], -1, 3)
                     for z in range(Z)])
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-14)


def test_sharded_engine_marches_own_lines(monkeypatch):
    """Through the regular engine on a ("lam", "y") mesh, with the kernel
    path taken, each device marches half of a mirror group's lines and
    the iteration equals the unsharded one."""
    from test_parallel import _run_one_iteration
    from voronoirt_tpu import Config, synthetic_atmosphere
    from voronoirt_tpu.engine import RegularEngine
    from voronoirt_tpu.parallel import make_mesh, shard_regular
    from voronoirt_tpu.physics import lyman_alpha_line
    from voronoirt_tpu.physics.atom import pad_line
    from voronoirt_tpu.solvers import march_cuda
    seen = []
    march = march_cuda.line_partitioned(_scan_recording(seen))
    monkeypatch.setattr(march_cuda, "kernel_selected", lambda d: True)
    monkeypatch.setattr(march_cuda, "march_lines", lambda c, k, f, s, n: (
        march(c, k, march_cuda.f_rows(f, k.shape[1], k.dtype), s, n)))
    atmos = synthetic_atmosphere(nz=8, nx=8, ny=8, seed=3)
    cfg = Config(nlam_bb=5, nlam_bf=3, quadrature="ul7n12")
    line = pad_line(lyman_alpha_line(5, 3, jnp.asarray(atmos.temperature)),
                    12)
    J0, S0, P0 = _run_one_iteration(RegularEngine(atmos, line, cfg))
    assert set(seen) == {(8, 48, 8)}        # 4 angles x 12 lambda
    seen.clear()
    eng = RegularEngine(atmos, line, cfg)
    shard_regular(eng, make_mesh((2, 2), ("lam", "y")))
    J1, S1, P1 = _run_one_iteration(eng)
    assert (8, 24, 8) in seen
    np.testing.assert_allclose(J1, J0, rtol=1e-10)
    np.testing.assert_allclose(P1, P0, rtol=1e-8)


@pytest.mark.gpu
@pytest.mark.parametrize("B", [16, 91])
def test_cuda_march_matches_scan_on_card(B):
    if jax.default_backend() != "gpu":
        pytest.skip("CUDA march kernel needs an NVIDIA GPU")
    from voronoirt_tpu.solvers.march_cuda import march_lines
    rng = np.random.default_rng(B)
    shape = (256, B, 256)
    coeff = jnp.asarray(rng.uniform(0.0, 0.9, shape), jnp.float32)
    const = jnp.asarray(rng.uniform(0.0, 1.0, shape), jnp.float32)
    f = jnp.asarray(rng.uniform(0.0, 1.0, (B, 1)), jnp.float32)
    got = np.asarray(march_lines(coeff, const, f, -1, 3))
    want = np.asarray(sr._march_scan(coeff, const, f, -1, 3))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6)
