"""Scaling-efficiency harness (the plot_threads_time.py analog).

Runs one jitted Lambda-iteration J pass at increasing mesh sizes and
reports parallel efficiency.  With platform="cpu" it exercises the
sharding mechanism on virtual CPU devices (mechanism validation, not a
hardware measurement -- virtual devices share the same cores); with
several accelerators (e.g. four GPUs of one host) the same harness
measures scaling across them.

Output: one JSON line per mesh size + an efficiency summary.
"""

import json
import time


def _parse_mesh(spec):
    """ "8" -> ((8,), ("y",));  "2x4" -> ((2, 4), ("x", "y")). """
    if isinstance(spec, int):
        return (spec,), ("y",)
    parts = tuple(int(s) for s in str(spec).split("x"))
    if len(parts) == 1:
        return parts, ("y",)
    if len(parts) == 2:
        return parts, ("x", "y")
    raise ValueError(f"bad mesh spec {spec!r} (use N or NxM)")


def run(mesh_sizes=(1, 2, 4, 8), platform="cpu", nz=16, nx=16, ny=32,
        nlam_bb=5, nlam_bf=3, mode="mesh", hosts=False, engine="regular",
        n_sites=20000, _presetup=False):
    """mode="mesh": spatial/lambda GSPMD sharding (mesh specs "N" for a
    1-D y mesh or "NxM" for an (x, y) mesh; with hosts=True the x axis
    is laid out as the process axis via make_hybrid_mesh, emulating
    N-process scaling in a single process).  mode="angles": quadrature
    MPMD round-robin.  engine="voronoi" runs the irregular engine with
    the site axis sharded instead."""
    import numpy as _np
    specs = [_parse_mesh(s) for s in mesh_sizes]
    n_max = max(int(_np.prod(s)) for s, _ in specs)
    if not _presetup:
        from voronoirt_tpu.platform import setup, distributed_init
        setup(platform=platform, x64=True, n_cpu_devices=n_max)
        distributed_init()

    import jax
    import jax.numpy as jnp
    import numpy as np
    from voronoirt_tpu import Config, synthetic_atmosphere
    from voronoirt_tpu.physics import lyman_alpha_line
    from voronoirt_tpu.engine import RegularEngine, VoronoiEngine
    from voronoirt_tpu.parallel import (make_mesh, make_hybrid_mesh,
                                        shard_regular, shard_voronoi)

    cfg = Config(nlam_bb=nlam_bb, nlam_bf=nlam_bf, quadrature="ul2n3")
    atmos = synthetic_atmosphere(nz=nz, nx=nx, ny=ny, seed=3)
    line_T = jnp.asarray(atmos.temperature)
    sites = None
    if engine == "voronoi":
        from voronoirt_tpu.grid import build_sites, initialise_sites
        from voronoirt_tpu.grid.sampling import sample_sites
        # multiple of every tested device count so the site axis shards
        n_sites -= n_sites % n_max
        pos = sample_sites(atmos, n_sites, density="invNH_invT", seed=7)
        bounds = (atmos.z[0], atmos.z[-1], atmos.x[0], atmos.x[-1],
                  atmos.y[0], atmos.y[-1])
        sites = build_sites(pos, bounds, initialise_sites(pos, atmos))
        line_T = jnp.asarray(sites.temperature)
    line = lyman_alpha_line(cfg.nlam_bb, cfg.nlam_bf, line_T)

    results = []
    for spec, (shape, axes) in zip(mesh_sizes, specs):
        n_dev = int(np.prod(shape))
        if engine == "voronoi":
            eng = VoronoiEngine(sites, line, cfg)
            if n_dev > 1 and mode == "mesh":
                mesh = make_mesh(shape, ("site",) if len(shape) == 1
                                 else ("lam", "site"),
                                 devices=jax.devices()[:n_dev])
                shard_voronoi(eng, mesh)
            elif n_dev > 1:
                from voronoirt_tpu.parallel import distribute_angles
                distribute_angles(eng, jax.devices()[:n_dev])
        else:
            eng = RegularEngine(atmos, line, cfg)
            if n_dev > 1 and mode == "mesh":
                if hosts and "x" in axes:
                    mesh = make_hybrid_mesh(shape, axes,
                                            process_axes=("x",),
                                            devices=jax.devices()[:n_dev])
                else:
                    mesh = make_mesh(shape, axes,
                                     devices=jax.devices()[:n_dev])
                shard_regular(eng, mesh)
            elif n_dev > 1:   # mode == "angles": quadrature MPMD
                from voronoirt_tpu.parallel import distribute_angles
                distribute_angles(eng, jax.devices()[:n_dev])

        def one_pass():
            damping_lam = eng.damping_lam(eng.lte)
            J = eng.compute_J(eng.B0, eng.lte, damping_lam)
            return J

        jax.block_until_ready(one_pass())  # compile
        reps = 3
        t0 = time.time()
        for _ in range(reps):
            J = one_pass()
        jax.block_until_ready(J)
        dt = (time.time() - t0) / reps
        results.append({"mesh": str(spec), "devices": n_dev,
                        "seconds_per_J": dt})
        print(json.dumps(results[-1]))

    t1 = results[0]["seconds_per_J"]
    for r in results:
        r["efficiency"] = t1 / (r["seconds_per_J"] * r["devices"])
    print(json.dumps({"engine": engine, "mode": mode,
                      "scaling": results}))
    return results


if __name__ == "__main__":
    import sys
    args = sys.argv[1:]
    mode = "mesh"
    hosts = False
    engine = "regular"
    out = None
    if "--angles" in args:
        mode = "angles"
        args.remove("--angles")
    if "--hosts" in args:
        hosts = True   # "NxM" meshes lay x across (emulated) processes
        args.remove("--hosts")
    if "--voronoi" in args:
        engine = "voronoi"
        args.remove("--voronoi")
    if "--all" in args:
        # the committed-artifact sweep: both engines, mesh + angle MPMD
        args.remove("--all")
        out = "artifacts/BENCH_SCALING.json"
        if args and args[0].startswith("--out="):
            out = args.pop(0).split("=", 1)[1]
        from voronoirt_tpu.platform import setup, distributed_init
        setup(platform="cpu", x64=True, n_cpu_devices=8)
        distributed_init()
        record = {"note": ("virtual CPU devices (8 on a 2-core host): "
                           "validates the sharding mechanism and the "
                           "collective layout, NOT hardware scaling -- "
                           "all virtual devices share the same cores, "
                           "so wall-clock efficiency saturates at the "
                           "physical core count.")}
        record["regular_mesh"] = run((1, 2, 4, 8), _presetup=True)
        record["regular_angles"] = run((1, 3), mode="angles",
                                       _presetup=True)
        record["voronoi_mesh"] = run((1, 2, 4, 8), engine="voronoi",
                                     _presetup=True)
        record["voronoi_angles"] = run((1, 3), mode="angles",
                                       engine="voronoi", _presetup=True)
        import os
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "w") as f:
            json.dump(record, f, indent=1)
        print(f"wrote {out}")
        sys.exit(0)
    sizes = tuple(args) or (1, 2, 4, 8)
    run(mesh_sizes=sizes, mode=mode, hosts=hosts, engine=engine)
