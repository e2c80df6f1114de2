"""Resume a crashed/killed NLTE run from its checkpoint file.

Reference parity: src/recover_simulation.jl (recover_regular :4-101,
recover_voronoi :103-206): rebuild all frozen state from the inputs, read
populations + S from the HDF5 output, scan the convergence dataset for
the first zero, and re-enter the Lambda loop mid-stream.

The checkpoint schema stores the full atmosphere/site fields, so --data
is only needed to regenerate nothing: everything is reloaded from the
file itself (an improvement over the reference, which re-runs voro++;
the tessellation here is re-derived from the stored positions).

Usage:
  python drivers/recover.py out.h5 [--eps E] [--maxiter N]
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


def load_engine_from_checkpoint(path, cfg):
    import h5py
    import jax.numpy as jnp
    from voronoirt_tpu.atmosphere import Atmosphere
    from voronoirt_tpu.physics import lyman_alpha_line
    from voronoirt_tpu.engine import RegularEngine, VoronoiEngine

    with h5py.File(path, "r") as f:
        n_bb = int(f["n_bb"][0])
        n_bf = int(f["n_bf"][0])
        is_voronoi = "positions" in f
        fields = {k: np.asarray(f[k]) for k in
                  ("temperature", "electron_density",
                   "hydrogen_populations", "velocity_z", "velocity_x",
                   "velocity_y")}
        if is_voronoi:
            positions = np.asarray(f["positions"]).T
            bounds = tuple(np.asarray(f["boundaries"]))
        else:
            z = np.asarray(f["z"])
            x = np.asarray(f["x"])
            y = np.asarray(f["y"])

    if is_voronoi:
        from voronoirt_tpu.grid import build_sites
        # resume hits the tessellation/plan disk cache (the first run
        # stored it under the same positions hash): no re-tessellation
        sites = build_sites(positions, bounds, fields,
                            cache_dir=cfg.cache_dir)
        line = lyman_alpha_line(n_bb, n_bf,
                                jnp.asarray(sites.temperature))
        return VoronoiEngine(sites, line, cfg), line
    atmos = Atmosphere(z=z, x=x, y=y, **fields)
    line = lyman_alpha_line(n_bb, n_bf, jnp.asarray(atmos.temperature))
    return RegularEngine(atmos, line, cfg), line


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("checkpoint")
    ap.add_argument("--eps", type=float, default=1e-3)
    ap.add_argument("--maxiter", type=int, default=150)
    ap.add_argument("--quadrature", default="ul7n12")
    ap.add_argument("--voronoi-order", default="layer",
                    choices=("layer", "wavefront"))
    ap.add_argument("--lambda-chunk", type=int, default=0)
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("--no-cache", action="store_true")
    ap.add_argument("--rates-chunk", type=int, default=0,
                    help="stream the rates/SE update over site slabs "
                         "(production memory path; must be set when "
                         "resuming multi-million-site runs)")
    ap.add_argument("--stream", action="store_true",
                    help="regular grid: lambda-streamed iteration")
    ap.add_argument("--boost", type=float, default=2.0e9,
                    help="collisional-rate boost; MUST match the "
                         "original run's value")
    args = ap.parse_args()

    import jax
    if args.f32:
        _platform_setup(platform=os.environ.get("VRT_PLATFORM") or None,
                        x64=False)
    else:
        jax.config.update("jax_enable_x64", True)
    from voronoirt_tpu import Config
    from voronoirt_tpu.engine.checkpoint import CheckpointFile, recover
    from voronoirt_tpu.grid.cache import default_cache_dir

    ckpt = CheckpointFile(args.checkpoint)
    import h5py
    with h5py.File(args.checkpoint, "r") as f:
        n_bb, n_bf = int(f["n_bb"][0]), int(f["n_bf"][0])
    cfg = Config(eps=args.eps, maxiter=args.maxiter, nlam_bb=n_bb,
                 nlam_bf=n_bf, quadrature=args.quadrature,
                 boost=args.boost,
                 voronoi_order=args.voronoi_order,
                 lambda_chunk=args.lambda_chunk or None,
                 rates_site_chunk=args.rates_chunk or None,
                 stream_rates=bool(args.stream),
                 dtype="float32" if args.f32 else "float64",
                 cache_dir=None if args.no_cache else default_cache_dir())

    eng, line = load_engine_from_checkpoint(args.checkpoint, cfg)
    it = ckpt.resume_iteration()
    print(f"---Resuming at iteration {it}---")
    t0 = time.time()
    res = recover(eng, args.checkpoint)
    print(json.dumps({"resumed_at": it, "iterations": res.iterations,
                      "converged": res.converged,
                      "wall_seconds": time.time() - t0}))


if __name__ == "__main__":
    main()
