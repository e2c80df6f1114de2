"""Microbenchmark: fit the Voronoi level-scan cost model on the device.

The wavefront schedule's row width (grid/voronoi.py, `_ROW_GATHER_S`,
`_LEVEL_S`) trades gather padding against scan-step count:

    cost(cap) = rows(cap) * (4 * cap * row_s + level_s)

This times, for a synthetic stage shaped like a production direction
(L levels x W sites x 2 upwinds, B lambda lanes over an n-row array),
the sweep's sequential path per level -- take(2W rows) + FMA + DUS --
at several widths W, and fits t_level(W) = level_s + 2 W row_s by
least squares.

Usage: python analysis/exp_gather_micro.py [--n 442368] [--L 400]
       [--B 91] [--widths 128 512 2048 8192]
"""

import argparse
import json
import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=442_368)
    ap.add_argument("--L", type=int, default=400)
    ap.add_argument("--B", type=int, default=91)
    ap.add_argument("--widths", type=int, nargs="+",
                    default=[128, 512, 2048, 8192])
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    from voronoirt_tpu.platform import setup
    setup(platform=os.environ.get("VRT_PLATFORM") or None, x64=False)
    import jax
    import jax.numpy as jnp
    import numpy as np

    N, L, B = args.n, args.L, args.B
    rng = np.random.default_rng(0)
    d_I = jnp.asarray(rng.uniform(0, 1, size=(N, B)).astype(np.float32))
    dev = jax.devices()[0]
    out = {"N": N, "L": L, "B": B,
           "device": {"platform": dev.platform, "kind": dev.device_kind},
           "level_s": {}}
    for W in args.widths:
        starts = jnp.asarray(
            (np.arange(L, dtype=np.int32) * W) % max(N - W, 1))
        up = jnp.asarray(rng.integers(0, N, size=(L, W, 2)).astype(np.int32))
        E = jnp.asarray(rng.uniform(0.1, 0.9, size=(L, W, 2)).astype(
            np.float32))

        @jax.jit
        def scan_gather_dus(I, starts=starts, up=up, E=E, W=W):
            def body(I, xs):
                s, u, e = xs
                i_u = jnp.take(I, u.reshape(-1), axis=0).reshape(W, 2, B)
                i_new = jnp.sum(e[..., None] * i_u, axis=1)
                I = jax.lax.dynamic_update_slice(
                    I, i_new, (s, jnp.zeros((), s.dtype)))
                return I, None
            I, _ = jax.lax.scan(body, I, (starts, up, E))
            return I

        jax.block_until_ready(scan_gather_dus(d_I))
        t0 = time.perf_counter()
        for _ in range(args.reps):
            res = scan_gather_dus(d_I)
        jax.block_until_ready(res)
        out["level_s"][W] = (time.perf_counter() - t0) / args.reps / L

    W = np.asarray(list(out["level_s"]), dtype=np.float64)
    t = np.asarray(list(out["level_s"].values()))
    A = np.stack([np.ones_like(W), 2.0 * W], axis=1)
    (level_s, row_s), *_ = np.linalg.lstsq(A, t, rcond=None)
    out["fit"] = {"level_s": float(level_s), "row_s": float(row_s)}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
