"""Flagship NLTE Ly-alpha line driver (config 4 of BASELINE.json).

Reference parity: src/compare_line.jl -- `compare(DATA, quadrature)` with
its `regular()` (:9-47) and `voronoi()` (:49-132) runs: production
configuration eps=1e-3, maxiter=150, 51 bb + 2x20 bf wavelengths,
ul7n12 quadrature; Voronoi sites sampled from the invNH_invT density
at half-resolution equivalent counts (compare_line.jl:64-74).

Works on the Bifrost snapshot (--data) or the synthetic atmosphere.

Usage:
  python drivers/line_nlte.py [--data F] [--grid regular|voronoi]
        [--n-sites N] [--skip K] [--out out.h5] [--maxiter N] [--eps E]
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", default=None)
    ap.add_argument("--skip", type=int, default=1)
    ap.add_argument("--grid", choices=("regular", "voronoi"),
                    default="regular")
    ap.add_argument("--n-sites", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--eps", type=float, default=1e-3)
    ap.add_argument("--maxiter", type=int, default=150)
    ap.add_argument("--nlam-bb", type=int, default=51)
    ap.add_argument("--nlam-bf", type=int, default=20)
    ap.add_argument("--quadrature", default="ul7n12")
    ap.add_argument("--seed", type=int, default=2022)
    ap.add_argument("--interpolation", default="linear",
                    choices=("linear", "bezier"),
                    help="formal-solution source interpolation; 'bezier'"
                         " = quadratic DELO-Bezier in the regular xy"
                         " sweep segments")
    ap.add_argument("--voronoi-order", default="layer",
                    choices=("layer", "wavefront"))
    ap.add_argument("--lambda-chunk", type=int, default=0,
                    help="stream wavelengths in blocks of this size "
                         "through profile->sweep->J (production-scale "
                         "memory bound); 0 = all at once")
    ap.add_argument("--f32", action="store_true",
                    help="float32 end to end (the production mode on the "
                         "GPU; default is float64 for validation runs)")
    ap.add_argument("--boost", type=float, default=2.0e9,
                    help="collisional-rate boost (rates.jl:3; the "
                         "reference's 2e9 drives the destruction "
                         "probability to ~1 and the iteration "
                         "converges in a few steps -- lower it for "
                         "deep-NLTE convergence studies)")
    ap.add_argument("--rates-chunk", type=int, default=0,
                    help="stream the rates/SE update over site slabs "
                         "of this size (production memory path); 0 = "
                         "all at once")
    ap.add_argument("--stream", action="store_true",
                    help="regular grid: lambda-streamed iteration "
                         "(cfg.stream_rates) -- no resident J cube, "
                         "second S buffer or Planck cube; required at "
                         "the 215x256x256 x 91 production shape")
    ap.add_argument("--no-cache", action="store_true",
                    help="disable the tessellation/plan disk cache")
    ap.add_argument("--atmos", type=int, nargs=3, default=(32, 16, 16),
                    metavar=("NZ", "NX", "NY"),
                    help="synthetic-atmosphere shape when --data is "
                         "not given (production benches use 192 128 "
                         "128; the reference's half-res Bifrost is "
                         "215 256 256)")
    ap.add_argument("--atmos-seed", type=int, default=5,
                    help="synthetic-atmosphere seed (5 matches the "
                         "bench atmospheres so site caches are shared)")
    args = ap.parse_args()

    import jax
    if args.f32:
        _platform_setup(platform=os.environ.get("VRT_PLATFORM") or None,
                        x64=False)
    else:
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from voronoirt_tpu import Config, get_atmos, synthetic_atmosphere
    from voronoirt_tpu.atmosphere import atmosphere_with_ghosts
    from voronoirt_tpu.physics import lyman_alpha_line
    from voronoirt_tpu.engine import RegularEngine, VoronoiEngine
    from voronoirt_tpu.engine.checkpoint import CheckpointFile
    from voronoirt_tpu.grid.cache import default_cache_dir

    cfg = Config(eps=args.eps, maxiter=args.maxiter, nlam_bb=args.nlam_bb,
                 nlam_bf=args.nlam_bf, quadrature=args.quadrature,
                 seed=args.seed, boost=args.boost,
                 formal_interpolation=args.interpolation,
                 voronoi_order=args.voronoi_order,
                 lambda_chunk=args.lambda_chunk or None,
                 rates_site_chunk=args.rates_chunk or None,
                 stream_rates=bool(args.stream),
                 dtype="float32" if args.f32 else "float64",
                 cache_dir=None if args.no_cache else default_cache_dir())

    from voronoirt_tpu.observability.metrics import (CompileClock,
                                                     device_memory)
    clock = CompileClock().__enter__()
    t_start = time.time()
    if args.data:
        atmos = get_atmos(args.data, periodic=False, skip=args.skip)
    else:
        nz, nx, ny = args.atmos
        atmos = synthetic_atmosphere(nz=nz, nx=nx, ny=ny,
                                     seed=args.atmos_seed)

    t_atmos = time.time() - t_start
    ckpt = None
    if args.grid == "regular":
        line = lyman_alpha_line(cfg.nlam_bb, cfg.nlam_bf,
                                jnp.asarray(atmos.temperature))
        eng = RegularEngine(atmos, line, cfg)
        if args.out:
            ckpt = CheckpointFile(args.out)
            ckpt.create_regular(line, atmos, cfg.maxiter)
    else:
        from voronoirt_tpu.grid import build_sites, initialise_sites
        from voronoirt_tpu.grid.sampling import sample_sites
        n_sites = args.n_sites or (atmos.shape[0] * atmos.shape[1]
                                   * atmos.shape[2])
        print(f"---Sampling {n_sites} sites (invNH_invT)---")
        pos = sample_sites(atmos, n_sites, density="invNH_invT",
                           seed=cfg.seed)
        bounds = (atmos.z[0], atmos.z[-1], atmos.x[0], atmos.x[-1],
                  atmos.y[0], atmos.y[-1])
        fields = initialise_sites(pos, atmos)
        t0 = time.time()
        sites = build_sites(pos, bounds, fields, cache_dir=cfg.cache_dir)
        print(f"---Tessellated in {time.time()-t0:.1f}s---")
        line = lyman_alpha_line(cfg.nlam_bb, cfg.nlam_bf,
                                jnp.asarray(sites.temperature))
        eng = VoronoiEngine(sites, line, cfg)
        if args.out:
            ckpt = CheckpointFile(args.out)
            ckpt.create_voronoi(line, sites, cfg.maxiter)

    t_setup = time.time() - t_start
    res = eng.run(checkpoint=ckpt)
    wall = time.time() - t_start
    clock.__exit__(None, None, None)
    if ckpt is not None:
        ckpt.write_time(wall)

    dev = jax.devices()[0]
    mem = device_memory(dev)
    print(json.dumps({
        "grid": args.grid, "iterations": res.iterations,
        "converged": res.converged, "wall_seconds": wall,
        "final_diff": res.convergence[-1],
        "mean_iteration_seconds": (float(np.mean(res.timings))
                                   if res.timings else None),
        "atmosphere_seconds": t_atmos,
        "setup_seconds": t_setup,
        "first_iteration_seconds": (res.timings[0] if res.timings
                                    else None),
        "warm_iteration_seconds": (float(np.mean(res.timings[1:]))
                                   if len(res.timings) > 1 else None),
        "compile_seconds": clock.seconds,
        "compile_cache_hits": clock.cache_hits,
        "peak_bytes_in_use": mem["peak_bytes_in_use"],
        "bytes_limit": mem["bytes_limit"],
        "device": {"platform": dev.platform, "kind": dev.device_kind},
    }))


if __name__ == "__main__":
    main()
