"""Sharded-vs-unsharded equality on a virtual 8-device CPU mesh.

The multi-host/distributed contract (SURVEY.md §4.4): the same fixture on
a mesh must equal the 1-device result up to reduction order.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from voronoirt_tpu import Config, synthetic_atmosphere
from voronoirt_tpu.physics import lyman_alpha_line
from voronoirt_tpu.engine import RegularEngine
from voronoirt_tpu.parallel import make_mesh, shard_regular


def _run_one_iteration(eng):
    from voronoirt_tpu.engine.lambda_iter import (_update_S,
                                                  _rates_and_populations)
    pops = eng.lte
    S = eng.B0
    damping_lam = eng.damping_lam(pops)
    J = eng.compute_J(S, pops, damping_lam)
    S_new = _update_S(eng.line, eng.eps, J, eng.B0)
    pops_new = _rates_and_populations(eng.line, J, damping_lam, eng.lte,
                                      eng.C, eng.T, eng.nH, eng.cfg.compat)
    return np.asarray(J), np.asarray(S_new), np.asarray(pops_new)


@pytest.mark.parametrize("mesh_shape,axes", [((8,), ("y",)),
                                             ((2, 4), ("lam", "y")),
                                             ((4, 2), ("x", "y"))])
def test_regular_sharded_matches_unsharded(mesh_shape, axes):
    assert len(jax.devices()) >= 8
    atmos = synthetic_atmosphere(nz=8, nx=8, ny=8, seed=3)
    cfg = Config(nlam_bb=5, nlam_bf=3, quadrature="ul2n3")  # nlam = 11
    # lambda axis (11) is not divisible by 2 -> only shard it when the
    # mesh really has a lam axis of size dividing nlam; use nlam=11 with
    # lam axis 1 unsupported -> instead pick nlam divisible: nbb=5,nbf=3
    # gives 11; for the (2,4) case use a padded-lambda config below.
    line = lyman_alpha_line(cfg.nlam_bb, cfg.nlam_bf,
                            jnp.asarray(atmos.temperature))
    if "lam" in axes and mesh_shape[axes.index("lam")] > 1:
        # nlam is odd by construction (forced-odd bb grid): pad to the
        # next multiple of the lam-shard count with dummy wavelengths
        from voronoirt_tpu.physics.atom import pad_line
        n_lam_shards = mesh_shape[axes.index("lam")]
        target = -(-line.n_lambda // n_lam_shards) * n_lam_shards
        line = pad_line(line, target)
    ref_eng = RegularEngine(atmos, line, cfg)
    J0, S0, P0 = _run_one_iteration(ref_eng)

    eng = RegularEngine(atmos, line, cfg)
    mesh = make_mesh(mesh_shape, axes)
    shard_regular(eng, mesh)
    J1, S1, P1 = _run_one_iteration(eng)

    assert np.allclose(J0, J1, rtol=1e-10)
    assert np.allclose(S0, S1, rtol=1e-10)
    assert np.allclose(P0, P1, rtol=1e-8)


def test_voronoi_sharded_matches_unsharded():
    from voronoirt_tpu.grid import build_sites, initialise_sites
    from voronoirt_tpu.grid.sampling import sample_sites
    from voronoirt_tpu.engine import VoronoiEngine
    from voronoirt_tpu.parallel import shard_voronoi
    from voronoirt_tpu.physics import lyman_alpha_line

    atmos = synthetic_atmosphere(nz=8, nx=6, ny=6, seed=13)
    cfg = Config(nlam_bb=5, nlam_bf=3, quadrature="n2")
    n_sites = 512  # divisible by 8
    pos = sample_sites(atmos, n_sites, seed=21)
    bounds = (atmos.z[0], atmos.z[-1], atmos.x[0], atmos.x[-1],
              atmos.y[0], atmos.y[-1])
    sites = build_sites(pos, bounds, initialise_sites(pos, atmos))
    line = lyman_alpha_line(cfg.nlam_bb, cfg.nlam_bf,
                            jnp.asarray(sites.temperature))

    def one_iter(eng):
        from voronoirt_tpu.engine.lambda_iter import (
            _update_S, _rates_and_populations)
        damping_lam = eng.damping_lam(eng.lte)
        J = eng.compute_J(eng.B0, eng.lte, damping_lam)
        S = _update_S(eng.line, eng.eps, J, eng.B0)
        P = _rates_and_populations(eng.line, J, damping_lam, eng.lte,
                                   eng.C, eng.T, eng.nH, eng.cfg.compat)
        return np.asarray(J), np.asarray(S), np.asarray(P)

    J0, S0, P0 = one_iter(VoronoiEngine(sites, line, cfg))
    eng = VoronoiEngine(sites, line, cfg)
    mesh = make_mesh((8,), ("y",))
    from voronoirt_tpu.parallel import shard_voronoi as sv
    sv(eng, mesh)
    J1, S1, P1 = one_iter(eng)
    assert np.allclose(J0, J1, rtol=1e-10)
    assert np.allclose(S0, S1, rtol=1e-10)
    assert np.allclose(P0, P1, rtol=1e-8)


def test_regular_angle_distribution_matches_serial():
    """Angle MPMD (parallel/angles.py): round-robin the quadrature over
    4 devices, J must equal the serial loop up to reduction order."""
    from voronoirt_tpu.parallel import distribute_angles

    atmos = synthetic_atmosphere(nz=8, nx=8, ny=8, seed=3)
    cfg = Config(nlam_bb=5, nlam_bf=3, quadrature="ul2n3")
    line = lyman_alpha_line(cfg.nlam_bb, cfg.nlam_bf,
                            jnp.asarray(atmos.temperature))
    J0, S0, P0 = _run_one_iteration(RegularEngine(atmos, line, cfg))

    eng = RegularEngine(atmos, line, cfg)
    distribute_angles(eng, jax.devices()[:4])
    J1, S1, P1 = _run_one_iteration(eng)
    assert np.allclose(J0, J1, rtol=1e-12)
    assert np.allclose(S0, S1, rtol=1e-12)
    assert np.allclose(P0, P1, rtol=1e-10)


def test_voronoi_angle_distribution_matches_serial():
    from voronoirt_tpu.grid import build_sites, initialise_sites
    from voronoirt_tpu.grid.sampling import sample_sites
    from voronoirt_tpu.engine import VoronoiEngine
    from voronoirt_tpu.parallel import distribute_angles
    from voronoirt_tpu.engine.lambda_iter import (_update_S,
                                                  _rates_and_populations)

    atmos = synthetic_atmosphere(nz=8, nx=6, ny=6, seed=13)
    cfg = Config(nlam_bb=5, nlam_bf=3, quadrature="n2",
                 lambda_chunk=4)   # chunked + distributed compose
    n_sites = 500
    pos = sample_sites(atmos, n_sites, seed=21)
    bounds = (atmos.z[0], atmos.z[-1], atmos.x[0], atmos.x[-1],
              atmos.y[0], atmos.y[-1])
    sites = build_sites(pos, bounds, initialise_sites(pos, atmos))
    line = lyman_alpha_line(cfg.nlam_bb, cfg.nlam_bf,
                            jnp.asarray(sites.temperature))

    def one_iter(eng):
        damping_lam = eng.damping_lam(eng.lte)
        J = eng.compute_J(eng.B0, eng.lte, damping_lam)
        S = _update_S(eng.line, eng.eps, J, eng.B0)
        return np.asarray(J), np.asarray(S)

    J0, S0 = one_iter(VoronoiEngine(sites, line, cfg))
    eng = VoronoiEngine(sites, line, cfg)
    distribute_angles(eng, jax.devices()[:3])
    J1, S1 = one_iter(eng)
    assert np.allclose(J0, J1, rtol=1e-12)
    assert np.allclose(S0, S1, rtol=1e-12)


def test_hybrid_mesh_multihost_layout_matches_unsharded():
    """make_hybrid_mesh with x as the process axis: same-device-layout
    contract (process axis slowest-varying) + full-iteration equality."""
    from voronoirt_tpu.parallel import make_hybrid_mesh

    mesh = make_hybrid_mesh((2, 2, 2), ("x", "lam", "y"),
                            process_axes=("x",))
    devs = np.asarray(jax.devices()[:8]).reshape(2, 2, 2)
    # x (the emulated process axis) must vary slowest
    assert (np.asarray(mesh.devices) == devs).all()

    atmos = synthetic_atmosphere(nz=8, nx=8, ny=8, seed=3)
    cfg = Config(nlam_bb=5, nlam_bf=3, quadrature="ul2n3")
    line = lyman_alpha_line(cfg.nlam_bb, cfg.nlam_bf,
                            jnp.asarray(atmos.temperature))
    from voronoirt_tpu.physics.atom import pad_line
    line = pad_line(line, -(-line.n_lambda // 2) * 2)
    J0, S0, P0 = _run_one_iteration(RegularEngine(atmos, line, cfg))

    eng = RegularEngine(atmos, line, cfg)
    shard_regular(eng, mesh)
    J1, S1, P1 = _run_one_iteration(eng)
    assert np.allclose(J0, J1, rtol=1e-10)
    assert np.allclose(S0, S1, rtol=1e-10)
    assert np.allclose(P0, P1, rtol=1e-8)


def test_grouped_angle_sweeps_match_per_angle():
    """Mirror-angle batched sweeps (sweep_batched via plan_groups) must
    equal the per-angle path; uniform z so that pairs actually form."""
    import dataclasses
    atmos = synthetic_atmosphere(nz=10, nx=8, ny=8, seed=3)
    atmos = dataclasses.replace(
        atmos, z=np.linspace(atmos.z[0], atmos.z[-1], len(atmos.z)))
    cfg = Config(nlam_bb=5, nlam_bf=3, quadrature="ul7n12")
    line = lyman_alpha_line(cfg.nlam_bb, cfg.nlam_bf,
                            jnp.asarray(atmos.temperature))
    eng = RegularEngine(atmos, line, cfg)
    assert any(len(g) > 1 for g in eng.plan_groups), \
        "expected mirror pairs on a uniform grid"
    J1, S1, P1 = _run_one_iteration(eng)

    eng0 = RegularEngine(atmos, line, cfg)
    # force the per-angle path by breaking every group into singletons
    eng0.plan_groups = [[m] for g in eng0.plan_groups for m in g]
    J0, S0, P0 = _run_one_iteration(eng0)
    assert np.allclose(J0, J1, rtol=1e-12)
    assert np.allclose(S0, S1, rtol=1e-12)
