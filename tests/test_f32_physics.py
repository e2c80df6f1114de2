"""float32 production-physics gate (ROADMAP 8).

The production transport path runs float32; the physics layer historically
needed float64 (Saha/Planck/rate exp ranges).  These tests pin the
float32-safe reformulations (log-space Planck prefactors, host-folded
de Broglie constants, reassociated density products, factored 2x2
Cramer solve) against the float64 results over the production parameter
ranges, and an end-to-end float32 NLTE iteration (subprocess with x64
disabled) against the float64 engine.

Production ranges covered: T in [2500, 5e4] K, n_e/n_H in [1e14, 1e23]
m^-3, the full 91-point Ly-alpha wavelength grid (22.8 nm bf edge --
the float32 denormal hazard -- through 364.7 nm).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import jax.numpy as jnp

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def _param_grid():
    T = np.geomspace(2500.0, 5e4, 7)
    n_e = np.geomspace(1e14, 1e23, 7)
    TT, NN = np.meshgrid(T, n_e, indexing="ij")
    return TT.ravel(), NN.ravel()


def _close(a32, a64, rtol, name):
    a32 = np.asarray(a32, dtype=np.float64)
    a64 = np.asarray(a64)
    assert np.all(np.isfinite(a32)), f"{name}: non-finite float32 values"
    scale = np.max(np.abs(a64))
    np.testing.assert_allclose(a32, a64, rtol=rtol, atol=rtol * scale,
                               err_msg=name)


def test_planck_f32_matches_f64():
    from voronoirt_tpu.physics.planck import B_lambda, B_nu
    T, _ = _param_grid()
    lam = np.geomspace(22.8e-9, 364.7e-9, 11)
    L, TT = np.meshgrid(lam, T, indexing="ij")
    b64 = B_lambda(jnp.asarray(L), jnp.asarray(TT))
    b32 = B_lambda(jnp.asarray(L, jnp.float32), jnp.asarray(TT, jnp.float32))
    _close(b32, b64, 2e-4, "B_lambda")
    n64 = B_nu(jnp.asarray(3e8 / L), jnp.asarray(TT))
    n32 = B_nu(jnp.asarray(3e8 / L, jnp.float32),
               jnp.asarray(TT, jnp.float32))
    _close(n32, n64, 2e-4, "B_nu")


def test_opacity_f32_matches_f64():
    from voronoirt_tpu.physics.opacity import (alpha_absorption,
                                               alpha_scattering)
    T, n_e = _param_grid()
    n_h1 = n_e * 10.0          # representative neutral/proton mix
    n_p = n_e * 0.1
    for lam in (22.8e-9, 121.568e-9, 364.7e-9, 500e-9):
        args64 = (jnp.asarray(lam), jnp.asarray(T), jnp.asarray(n_e),
                  jnp.asarray(n_h1), jnp.asarray(n_p))
        args32 = tuple(jnp.asarray(a, jnp.float32) for a in args64)
        _close(alpha_absorption(*args32), alpha_absorption(*args64),
               5e-3, f"alpha_absorption@{lam}")
        _close(alpha_scattering(args32[0], args32[2], args32[3]),
               alpha_scattering(args64[0], args64[2], args64[3]),
               1e-4, f"alpha_scattering@{lam}")


def test_lte_and_stateq_f32():
    from voronoirt_tpu.physics import lyman_alpha_line
    from voronoirt_tpu.physics.lte import lte_populations
    T, n_e = _param_grid()
    n_H = n_e * 3.0
    line = lyman_alpha_line(5, 3, jnp.asarray(T))
    p64 = lte_populations(line, jnp.asarray(T), jnp.asarray(n_e),
                          jnp.asarray(n_H))
    line32 = line.with_temperature(jnp.asarray(T, jnp.float32))
    p32 = lte_populations(line32, jnp.asarray(T, jnp.float32),
                          jnp.asarray(n_e, jnp.float32),
                          jnp.asarray(n_H, jnp.float32))
    # per-level relative agreement where the f64 population is
    # representable in float32 at all (level fractions span e^-large)
    p32 = np.asarray(p32, dtype=np.float64)
    p64 = np.asarray(p64)
    mask = p64 > 1e-30 * p64.max()
    rel = np.abs(p32 - p64)[mask] / p64[mask]
    assert np.all(np.isfinite(p32))
    assert rel.max() < 5e-3


_F32_RUN = r"""
import json, sys
from voronoirt_tpu.platform import setup
setup(platform="cpu", x64=False)
import numpy as np
import jax.numpy as jnp
from voronoirt_tpu import Config, synthetic_atmosphere
from voronoirt_tpu.engine import RegularEngine
from voronoirt_tpu.physics import lyman_alpha_line

atmos = synthetic_atmosphere(nz=12, nx=8, ny=8, seed=7)
cfg = Config(nlam_bb=5, nlam_bf=3, quadrature="n2", maxiter=2, eps=1e-9)
line = lyman_alpha_line(5, 3, jnp.asarray(atmos.temperature))
eng = RegularEngine(atmos, line, cfg)
res = eng.run()
np.savez(sys.argv[1], J=res.J, S=res.S, populations=res.populations)
"""


def test_nlte_iteration_f32_vs_f64(tmp_path):
    """Two full float32 Lambda iterations vs the float64 engine."""
    out = str(tmp_path / "f32.npz")
    proc = subprocess.run([sys.executable, "-c", _F32_RUN, out],
                          capture_output=True, text=True, timeout=600,
                          env=dict(os.environ, VRT_PLATFORM="cpu"))
    assert proc.returncode == 0, proc.stderr[-2000:]
    f32 = np.load(out)

    from voronoirt_tpu import Config, synthetic_atmosphere
    from voronoirt_tpu.engine import RegularEngine
    from voronoirt_tpu.physics import lyman_alpha_line
    atmos = synthetic_atmosphere(nz=12, nx=8, ny=8, seed=7)
    cfg = Config(nlam_bb=5, nlam_bf=3, quadrature="n2", maxiter=2, eps=1e-9)
    line = lyman_alpha_line(5, 3, jnp.asarray(atmos.temperature))
    res = RegularEngine(atmos, line, cfg).run()

    for name, a64 in (("J", res.J), ("S", res.S),
                      ("populations", res.populations)):
        a32 = f32[name].astype(np.float64)
        assert np.all(np.isfinite(a32)), name
        scale = np.max(np.abs(a64))
        np.testing.assert_allclose(
            a32, np.asarray(a64), rtol=5e-3, atol=5e-3 * scale,
            err_msg=f"f32 vs f64 {name}")
