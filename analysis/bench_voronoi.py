"""Voronoi-sweep throughput probe (sites*rays/s on one device).

Builds an n-site irregular grid from the synthetic atmosphere, plans
one production direction, and times the formal solution with a
wavelength batch.  Usage:
    python analysis/bench_voronoi.py [n_sites] [batch] [order]
order: 'layer' (default, reference parity) or 'wavefront' (exact
upwind-DAG levels; the production ordering).
"""

import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)


def main(n_sites=500_000, B=16, order="layer"):
    from voronoirt_tpu.platform import setup
    setup(platform=os.environ.get("VRT_PLATFORM") or None, x64=False)

    import jax
    import jax.numpy as jnp
    import numpy as np
    from voronoirt_tpu import synthetic_atmosphere
    from voronoirt_tpu.grid import build_sites, initialise_sites
    from voronoirt_tpu.grid.sampling import sample_sites
    from voronoirt_tpu.grid.voronoi import build_voronoi_plan
    from voronoirt_tpu.quadrature import get_quadrature
    from voronoirt_tpu.solvers.sweep_voronoi import sweep_voronoi

    atmos = synthetic_atmosphere(nz=64, nx=64, ny=64, seed=5)
    t0 = time.time()
    pos = sample_sites(atmos, n_sites, seed=11)
    t_sample = time.time() - t0
    bounds = (atmos.z[0], atmos.z[-1], atmos.x[0], atmos.x[-1],
              atmos.y[0], atmos.y[-1])
    t0 = time.time()
    sites = build_sites(pos, bounds, initialise_sites(pos, atmos))
    t_tess = time.time() - t0

    quad = get_quadrature("ul7n12")
    i = 0  # one up-direction
    while not quad.is_up[i]:
        i += 1
    t0 = time.time()
    plan = build_voronoi_plan(sites, quad.k[i], True, order=order)
    t_plan = time.time() - t0

    rng = np.random.default_rng(0)
    S = jnp.asarray(rng.uniform(0.1, 1.0, (B, sites.n)), jnp.float32)
    alpha = jnp.asarray(10.0 ** rng.uniform(-9, -5, (B, sites.n)),
                        jnp.float32)
    I0 = jnp.asarray(rng.uniform(0.5, 1.0, (B, len(plan.bc_sites))),
                     jnp.float32)

    # dependency chain of K sweeps, ended by block_until_ready
    K = 3

    def chained(S):
        for _ in range(K):
            I = sweep_voronoi(plan, S, alpha, I0)
            S = 0.9 * S + 0.1 * I
        return jax.block_until_ready(S)

    t0 = time.time()
    _ = chained(S)
    t_compile = time.time() - t0
    reps = 3
    t0 = time.time()
    for _ in range(reps):
        _ = chained(S)
    dt = (time.time() - t0) / reps / K

    n_stages = len(plan.exact_levels) if plan.exact_levels is not None \
        else len(plan.layer_sites)
    import json
    print(json.dumps({
        "n_sites": sites.n, "batch": B, "order": order,
        "sites*rays/s": sites.n * B / dt,
        "seconds_per_sweep": dt,
        "t_sample": t_sample, "t_tessellate": t_tess, "t_plan": t_plan,
        "t_compile": t_compile, "n_sched_rows": int(n_stages),
        "device": {"platform": jax.devices()[0].platform,
                   "kind": jax.devices()[0].device_kind},
    }))


if __name__ == "__main__":
    a = sys.argv[1:]
    main(int(a[0]) if a else 500_000, int(a[1]) if len(a) > 1 else 16,
         a[2] if len(a) > 2 else "layer")
