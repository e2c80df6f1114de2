"""Formal-solution throughput benchmark (the do_timing analog).

Workload: full ul7n12 quadrature (12 statically planned sweeps) over a
Bifrost-like regular grid with a 16-wavelength batch (a realistic
lambda chunk of the 91-point production grid), iterated as a
Lambda-style dependency chain S <- 0.95 S + 0.05 J so repeated passes
can neither be CSE'd nor overlapped incorrectly.  Mirrors
src/compare_searchlight.jl:358-490 `do_timing` (12 angles x 1 lambda on
the half-res 215x256x256 snapshot) scaled by the lambda batch.

Timing: K chained passes, ended by block_until_ready.

Metric: grid-points * rays / second, rays = angles x wavelengths.

vs_baseline: ratio to the reference's best recorded throughput.  The
only published numbers are full-NLTE wall time vs thread count
(python/plot_threads_time.py: 6175 s @ 1 thread, 2330 s @ 10 threads).
The production workload is 12 angles x 91 lambda x 3.52e6 points per
iteration; assuming ~50 Lambda iterations per run, the 10-thread
throughput is 50*12*91*3.52e6/2330 = 8.2e7 grid-points*rays/s
(see BASELINE.md).
"""

import json
import time

REF_THROUGHPUT = 8.2e7  # grid-points*rays/s, reference @ 10 threads


def main(small=False):
    import os
    from voronoirt_tpu.platform import setup
    setup(platform=os.environ.get("VRT_PLATFORM") or None, x64=False)
    import jax
    import jax.numpy as jnp
    import numpy as np
    from voronoirt_tpu.quadrature import get_quadrature
    from voronoirt_tpu.solvers.sweep_regular import (
        build_plan, sweep, group_plans, sweep_group_J)

    if small:
        nz, nx, ny, nlam, K = 48, 64, 64, 4, 2
    else:
        nz, nx, ny, nlam, K = 192, 256, 256, 16, 3

    # Bifrost-like geometry: dz ~ dx/2 (half-res snapshot proportions)
    dx = 62.5e3
    z = np.arange(nz) * (dx / 2)
    quad = get_quadrature("ul7n12")

    rng = np.random.default_rng(0)
    dtype = jnp.float32
    S0 = jnp.asarray(rng.uniform(0.1, 1.0, (nz, nlam, nx, ny)), dtype)
    alpha = jnp.asarray(10.0 ** rng.uniform(-9, -5, (nz, nlam, nx, ny)),
                        dtype)
    I0 = jnp.asarray(rng.uniform(0.5, 1.0, (nlam, nx, ny)), dtype)

    plans = [build_plan(quad.k[i], z, dx, dx, bool(quad.is_up[i]))
             for i in range(quad.n_angles)]
    # mirror-quadrant angles batch into one sweep each (the marching
    # kernels are latency-bound; a pair costs ~one sweep)
    groups = group_plans(quad.k, quad.is_up, z, dx, dx)
    w = [float(v) for v in quad.weights]

    def J_pass(S):
        # sweep_group_J keeps each group's flip/stack/sweep inside one
        # jit, so per-group working sets (3.2 GB stacks at 4-angle
        # groups) are XLA temporaries allocated at execution -- eagerly
        # chaining the groups never holds more than one set.
        J = jnp.zeros_like(S)
        for g in groups:
            if len(g) == 1:
                (i, _, _) = g[0]
                J = J + w[i] * sweep(plans[i], S, alpha, I0, n_sweeps=3)
                continue
            J = J + sweep_group_J(
                tuple(p for (_, p, _) in g), S,
                tuple(alpha for _ in g), tuple(I0 for _ in g),
                jnp.asarray([w[i] for (i, _, _) in g], S.dtype),
                n_sweeps=3, flips=tuple(f for (_, _, f) in g))
        return J

    mix = jax.jit(lambda S, J: 0.95 * S + 0.05 * J)

    def chained(S):
        for _ in range(K):
            J = J_pass(S)
            S = mix(S, J)
        return jax.block_until_ready(S)

    # warmup/compile
    t0 = time.time()
    chained(S0)
    compile_s = time.time() - t0

    reps = 3
    t0 = time.time()
    for _ in range(reps):
        chained(S0)
    dt = (time.time() - t0) / reps / K

    pts_rays = nz * nx * ny * quad.n_angles * nlam
    throughput = pts_rays / dt
    dev = jax.devices()[0]
    result = {
        "metric": "grid-points*rays/s (formal solution, 12 angles)",
        "value": throughput,
        "unit": "pts*rays/s",
        "vs_baseline": throughput / REF_THROUGHPUT,
        "grid": [nz, nx, ny], "nlam": nlam,
        "seconds_per_J_pass": dt,
        "first_call_seconds": compile_s,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }
    print(json.dumps(result))


if __name__ == "__main__":
    import sys
    main(small="--small" in sys.argv)
