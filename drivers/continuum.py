"""LTE continuum disk-centre imaging driver (configs 2-3 of BASELINE.json).

Reference parity: src/compare_continuum.jl -- LTE_regular (:123-174,
single-pass 500 nm disk-centre formal solutions at several resolutions)
and LTE_compare (:12-120: sample sites from the extinction density,
tessellate, resample back to the regular grid, then solve -- isolating
grid-representation error).

Works on the Bifrost HDF5 snapshot when given (--data), otherwise on the
hermetic synthetic atmosphere.

Usage:
  python drivers/continuum.py [--data FILE] [--n-sites N] [--skip K] [--out DIR]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

# VRT_PLATFORM=cpu|gpu selects the backend (setup raises if another is
# already active); setup also enables the persistent compile cache
from voronoirt_tpu.platform import setup as _platform_setup
_platform_setup(platform=os.environ.get("VRT_PLATFORM") or None, x64=True)

import numpy as np

LAMBDA0 = 500e-9


def _load_atmos(args):
    from voronoirt_tpu import get_atmos, synthetic_atmosphere
    if args.data:
        return get_atmos(args.data, periodic=False, skip=args.skip)
    nz, nx, ny = getattr(args, "atmos", None) or (48, 32, 32)
    return synthetic_atmosphere(nz=nz, nx=nx, ny=ny, seed=1998)


def lte_continuum_fields(atmos):
    """alpha_cont(500 nm) and S = B_lambda(T) from ad-hoc LTE populations
    (compare_continuum.jl:78-92)."""
    import jax.numpy as jnp
    from voronoirt_tpu.physics import (lyman_alpha_line, lte_populations,
                                       alpha_absorption, alpha_scattering,
                                       B_lambda)
    T = jnp.asarray(atmos.temperature)
    ne = jnp.asarray(atmos.electron_density)
    nH = jnp.asarray(atmos.hydrogen_populations)
    line = lyman_alpha_line(1, 1, T)
    lte = lte_populations(line, T, ne, nH)
    a = alpha_absorption(LAMBDA0, T, ne, lte[..., 0] + lte[..., 1],
                         lte[..., 2])
    a = a + alpha_scattering(LAMBDA0, ne, lte[..., 0])
    S = B_lambda(LAMBDA0, T)
    return np.asarray(a), np.asarray(S)


def disk_centre_image(atmos, alpha, S):
    """Vertical-ray formal solution -> top-of-atmosphere intensity
    (compare_continuum.jl:100-118)."""
    from voronoirt_tpu.physics import B_lambda
    from voronoirt_tpu.solvers.sweep_regular import short_characteristics
    import jax.numpy as jnp
    k = np.array([-1.0, 0.0, 0.0])  # theta = 180: straight up
    I0 = np.asarray(B_lambda(LAMBDA0, jnp.asarray(atmos.temperature[0])))
    I = np.asarray(short_characteristics(
        k, S, alpha, I0, atmos.z, atmos.dx, atmos.dy, up=True))
    return I[-1]


def run_regular(atmos, out_dir=None, tag="regular"):
    t0 = time.time()
    alpha, S = lte_continuum_fields(atmos)
    img = disk_centre_image(atmos, alpha, S)
    dt = time.time() - t0
    print(f"LTE {tag}: {img.shape} image, mean {img.mean():.4g} "
          f"kW/m2/nm, {dt:.2f}s")
    if out_dir:
        np.save(os.path.join(out_dir, f"I_{tag}.npy"), img)
    return img


def run_voronoi(atmos, n_sites, out_dir=None, seed=1998):
    """Sites from the extinction density -> tessellate -> resample back ->
    regular-grid solve (compare_continuum.jl:40-118)."""
    import jax.numpy as jnp
    from voronoirt_tpu.physics import lyman_alpha_line, lte_populations
    from voronoirt_tpu.grid import (build_sites, initialise_sites,
                                    voronoi_to_raster_inv_dist)
    from voronoirt_tpu.grid.sampling import rejection_sampling, \
        density_extinction

    T = jnp.asarray(atmos.temperature)
    line = lyman_alpha_line(1, 1, T)
    lte = np.asarray(lte_populations(line, T,
                                     jnp.asarray(atmos.electron_density),
                                     jnp.asarray(atmos.hydrogen_populations)))
    q = density_extinction(atmos, LAMBDA0, lte)
    t0 = time.time()
    pos = rejection_sampling(n_sites, atmos, q, seed=seed)
    bounds = (atmos.z[0], atmos.z[-1], atmos.x[0], atmos.x[-1],
              atmos.y[0], atmos.y[-1])
    fields = initialise_sites(pos, atmos)
    sites = build_sites(pos, bounds, fields)
    print(f"sampled+tessellated {n_sites} sites in {time.time()-t0:.2f}s")

    # resample the site fields back to the regular grid (inverse distance,
    # k=2, p=1 -- compare_continuum.jl:80) and run the same formal solve
    import dataclasses
    resampled = {}
    for name in ("temperature", "electron_density", "hydrogen_populations",
                 "velocity_z", "velocity_x", "velocity_y"):
        resampled[name] = voronoi_to_raster_inv_dist(
            sites, atmos.z, atmos.x, atmos.y, getattr(sites, name))
    atmos_v = dataclasses.replace(atmos, **resampled)
    return run_regular(atmos_v, out_dir, tag=f"voronoi_{n_sites}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", default=None)
    ap.add_argument("--skip", type=int, default=1)
    ap.add_argument("--n-sites", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--atmos", type=int, nargs=3, default=(48, 32, 32),
                    metavar=("NZ", "NX", "NY"))
    args = ap.parse_args()
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    import jax
    jax.config.update("jax_enable_x64", True)
    atmos = _load_atmos(args)
    img_r = run_regular(atmos, args.out)
    summary = {"regular_mean": float(img_r.mean())}
    if args.n_sites:
        img_v = run_voronoi(atmos, args.n_sites, args.out)
        summary["voronoi_mean"] = float(img_v.mean())
        summary["rel_diff"] = float(
            np.mean(np.abs(img_v - img_r) / np.abs(img_r)))
    print(json.dumps(summary))
