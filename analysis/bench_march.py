"""Regular-sweep kernel measurements on the GPU.

  * unroll: the plain march scan (one z-plane, 256x256, 3 passes) at
    unroll U in {1, 4, 8, 16, 32}, for B lines;
  * xy: one jitted xy plane-cut step -- its fusions in the optimized
    HLO, its kernels per call in a profiler trace (device busy time),
    and its time against the 6 planes of bytes it must move (5 reads +
    1 write);
  * jpass: a full 12-angle ul7n12 J pass (mirror groups batched, as the
    engine runs it) with the CUDA march kernel ("kernel") and with the
    plain scan ("plain", march_cuda.kernel_selected swapped out and the
    compiled programs dropped), at 192x256x256 x 16 lambda and
    215x256x256 x 91 lambda (lambda chunked to the device-derived group
    budget);
  * mesh: the regular engine on a ("lam", "y") 2x2 mesh of four devices
    at 215x256x256 x 92 lambda (91 padded to split), lambda-streamed:
    two iterations with the kernel and two with the plain scan, the
    first and warm iteration seconds of each, and the kernel's S and
    populations after iteration 1 against the plain scan's.

Prints one JSON line per measurement and writes them all to --out.

Usage: python analysis/bench_march.py [--only unroll,xy,jpass,mesh]
           [--out chiprun_out/bench_march.json] [--trace-dir DIR]
"""

import argparse
import contextlib
import glob
import json
import math
import os
import sys
import time

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)


def _timed(fn, *args, reps=3):
    import jax
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def bench_unroll(rows, n=256, n_sweeps=3):
    import jax
    import jax.numpy as jnp
    from voronoirt_tpu.solvers import sweep_regular as sr
    rng = np.random.default_rng(0)
    for B in (16, 364):
        coeff = jnp.asarray(rng.uniform(0, 0.9, (n, B, n)), jnp.float32)
        const = jnp.asarray(rng.uniform(0, 1, (n, B, n)), jnp.float32)
        f = jnp.full((B, 1), 0.3, jnp.float32)
        rec = {"kind": "unroll", "B": B, "plane": [n, n]}
        for U in (1, 4, 8, 16, 32):
            fn = jax.jit(lambda c, k, U=U: sr._march_scan(c, k, f, -1,
                                                          n_sweeps,
                                                          unroll=U))
            rec[f"U{U}_s"] = _timed(fn, coeff, const)
        if jax.default_backend() == "gpu":
            from voronoirt_tpu.solvers.march_cuda import march_lines
            fk = jax.jit(lambda c, k: march_lines(c, k, f, -1, n_sweeps))
            rec["kernel_s"] = _timed(fk, coeff, const)
        rows.append(rec)
        print(json.dumps(rec), flush=True)


def _trace_kernels(trace_dir):
    """Per device line of the newest trace: event count and the most
    frequent names (the kernels on a GPU stream line)."""
    import jax
    paths = sorted(glob.glob(os.path.join(
        trace_dir, "plugins", "profile", "*", "*.xplane.pb")))
    pd = jax.profiler.ProfileData.from_file(paths[-1])
    lines = {}
    for plane in pd.planes:
        if not plane.name.startswith("/device"):
            continue
        for line in plane.lines:
            names = {}
            total = 0.0
            for ev in line.events:
                names[ev.name] = names.get(ev.name, 0) + 1
                total += ev.duration_ns
            top = sorted(names.items(), key=lambda kv: -kv[1])[:8]
            lines[f"{plane.name}|{line.name}"] = {
                "events": sum(names.values()), "busy_ns": total,
                "top": top}
    return lines


def bench_xy(rows, trace_dir, n=256, reps=20):
    import jax
    import jax.numpy as jnp
    from voronoirt_tpu.solvers import sweep_regular as sr
    plan = sr.RegularPlan(k=(0, 0, 0), up=True, sign_x=1, sign_y=1,
                          sxs=-1, sys=0, r_x=0, r_y=0, fy_line=0,
                          fx_line=0, segments=())
    rng = np.random.default_rng(1)
    for B in (16, 52):
        planes = [jnp.asarray(rng.uniform(0.1, 2.0, (B, n, n)), jnp.float32)
                  for _ in range(5)]
        plane_bytes = B * n * n * 4
        rec = {"kind": "xy", "B": B, "plane": [n, n],
               "bytes_6_planes": 6 * plane_bytes}
        step = jax.jit(lambda i, a_c, a_p, s_c, s_p: sr._xy_step(
            plan, i, (a_c, a_p, s_c, s_p, 1.3, 0.3, 0.7, 0.0))[0])
        hlo = step.lower(*planes).compile().as_text()
        rec["hlo_fusion_calls"] = sum(
            1 for ln in hlo.splitlines()
            if ln.strip().startswith(("ROOT", "%"))
            and " fusion(" in ln and "calls=" in ln)
        rec["step_s"] = _timed(step, *planes, reps=reps)
        if jax.default_backend() == "gpu":
            d = os.path.join(trace_dir, f"xy_B{B}")
            jax.profiler.start_trace(d)
            for _ in range(reps):
                out = step(*planes)
            jax.block_until_ready(out)
            jax.profiler.stop_trace()
            rec["trace"] = _trace_kernels(d)
        rows.append(rec)
        print(json.dumps(rec), flush=True)


@contextlib.contextmanager
def _march(mode):
    """Run the sweeps with the CUDA march kernel ("kernel") or the plain
    scan ("plain"); the choice is made at trace time, so the compiled
    programs are dropped on the way in and out."""
    import jax
    from voronoirt_tpu.solvers import march_cuda
    selected = march_cuda.kernel_selected
    if mode == "plain":
        march_cuda.kernel_selected = lambda dtype: False
    jax.clear_caches()
    try:
        yield
    finally:
        march_cuda.kernel_selected = selected
        jax.clear_caches()


def bench_jpass(rows, shapes=((192, 16), (215, 91)), n=256):
    import jax
    import jax.numpy as jnp
    from voronoirt_tpu import memory
    from voronoirt_tpu.quadrature import get_quadrature
    from voronoirt_tpu.solvers.sweep_regular import (
        build_plan, group_plans, sweep, sweep_group_J)
    quad = get_quadrature("ul7n12")
    dx = 2.0e6 / n
    for nz, nlam in shapes:
        z = np.linspace(-0.1e6, 2.0e6, nz)
        plans = [build_plan(quad.k[i], z, dx, dx, bool(quad.is_up[i]))
                 for i in range(quad.n_angles)]
        n_cells = nz * n * n
        widest = max(1, memory.group_stack_bytes() // (4 * 4 * n_cells))
        n_chunks = math.ceil(nlam / widest)
        chunk = math.ceil(nlam / n_chunks)
        max_group = max(1, memory.group_stack_bytes()
                        // (4 * chunk * n_cells))
        groups = group_plans(quad.k, quad.is_up, z, dx, dx,
                             max_group=max_group)
        rng = np.random.default_rng(0)
        S = jnp.asarray(rng.uniform(0.1, 1.0, (nz, nlam, n, n)),
                        jnp.float32)
        alpha = jnp.asarray(10.0 ** rng.uniform(-9, -5, (nz, nlam, n, n)),
                            jnp.float32)
        w = [float(v) for v in quad.weights]
        chunks = [slice(i, min(i + chunk, nlam))
                  for i in range(0, nlam, chunk)]

        def J_pass():
            parts = []
            for sl in chunks:
                S_c, a_c = S[:, sl], alpha[:, sl]
                I0 = jnp.ones(S_c.shape[1:], S_c.dtype)
                J = jnp.zeros_like(S_c)
                for g in groups:
                    if len(g) == 1:
                        (i, _, _) = g[0]
                        J = J + w[i] * sweep(plans[i], S_c, a_c, I0,
                                             n_sweeps=3)
                        continue
                    J = J + sweep_group_J(
                        tuple(p for (_, p, _) in g), S_c,
                        tuple(a_c for _ in g), tuple(I0 for _ in g),
                        jnp.asarray([w[i] for (i, _, _) in g], S_c.dtype),
                        n_sweeps=3, flips=tuple(f for (_, _, f) in g))
                parts.append(jax.block_until_ready(J))
            return parts

        rec = {"kind": "jpass", "grid": [nz, n, n], "nlam": nlam,
               "lambda_chunk": chunk, "max_group": max_group,
               "groups": [len(g) for g in groups]}
        ref = None
        modes = ("plain", "kernel") if jax.default_backend() == "gpu" \
            else ("plain",)
        for mode in modes:
            with _march(mode):
                t0 = time.perf_counter()
                out = J_pass()
                rec[f"{mode}_first_call_s"] = time.perf_counter() - t0
                reps = 2 if nlam <= 16 else 1
                t0 = time.perf_counter()
                for _ in range(reps):
                    out = J_pass()
                rec[f"{mode}_s"] = (time.perf_counter() - t0) / reps
            got = np.concatenate([np.asarray(p) for p in out], axis=1)
            if ref is None:
                ref = got
            else:
                rec[f"{mode}_max_rel_diff_vs_plain"] = float(np.max(
                    np.abs(got - ref) / (np.abs(ref) + 1e-30)))
            del out, got
        rows.append(rec)
        print(json.dumps(rec), flush=True)
        del S, alpha, ref


class _FirstState:
    """Checkpoint stand-in keeping a host copy of iteration 1's state."""

    def __init__(self):
        self.S = self.populations = None

    def write_convergence(self, i, diff):
        pass

    def write_state(self, populations, S):
        if self.S is None:
            self.S, self.populations = (np.asarray(S),
                                        np.asarray(populations))


def bench_mesh(rows, shape=(215, 256, 256), nlam=92):
    import jax
    import jax.numpy as jnp
    from voronoirt_tpu import Config, memory, synthetic_atmosphere
    from voronoirt_tpu.engine import RegularEngine
    from voronoirt_tpu.parallel import make_mesh, shard_regular
    from voronoirt_tpu.physics import lyman_alpha_line
    from voronoirt_tpu.physics.atom import pad_line
    mesh = make_mesh((2, 2), ("lam", "y"), devices=jax.devices()[:4])
    atmos = synthetic_atmosphere(*shape, seed=5)
    line = pad_line(lyman_alpha_line(51, 20, jnp.asarray(atmos.temperature)),
                    nlam)
    widest = max(1, memory.group_stack_bytes()
                 // (4 * 4 * int(np.prod(shape))))
    chunk = math.ceil(nlam / math.ceil(nlam / widest))
    cfg = Config(eps=0.0, maxiter=2, nlam_bb=51, nlam_bf=20,
                 quadrature="ul7n12", compat="reference", dtype="float32",
                 lambda_chunk=chunk, stream_rates=True)
    rec = {"kind": "mesh", "grid": list(shape), "nlam": nlam,
           "mesh": {"lam": 2, "y": 2}, "lambda_chunk": chunk}
    states = {}
    for mode in ("kernel", "plain"):
        with _march(mode):
            eng = shard_regular(RegularEngine(atmos, line, cfg), mesh)
            first = _FirstState()
            res = eng.run(checkpoint=first)
        rec[f"{mode}_first_iteration_s"] = res.timings[0]
        rec[f"{mode}_warm_iteration_s"] = res.timings[1]
        states[mode] = first
        del eng, res
    for name, ax in (("S", 0), ("populations", 3)):
        a = np.asarray(getattr(states["kernel"], name), np.float64)
        b = np.asarray(getattr(states["plain"], name), np.float64)
        other = tuple(i for i in range(b.ndim) if i != ax)
        rec[f"kernel_vs_plain_{name}"] = float(np.max(
            np.max(np.abs(a - b), axis=other)
            / np.maximum(np.max(np.abs(b), axis=other), 1e-300)))
    rows.append(rec)
    print(json.dumps(rec), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default="unroll,xy,jpass")
    ap.add_argument("--out", default=os.path.join(_ROOT, "chiprun_out",
                                                  "bench_march.json"))
    ap.add_argument("--trace-dir", default=os.path.join(
        _ROOT, "chiprun_out", "traces"))
    args = ap.parse_args()
    from voronoirt_tpu.platform import setup
    setup(platform=os.environ.get("VRT_PLATFORM") or None, x64=False)
    import jax
    d = jax.devices()[0]
    rows = [{"device": {"platform": d.platform, "kind": d.device_kind,
                        "count": len(jax.devices())}}]
    only = set(args.only.split(","))
    try:
        if "unroll" in only:
            bench_unroll(rows)
        if "xy" in only:
            bench_xy(rows, args.trace_dir)
        if "jpass" in only:
            bench_jpass(rows)
        if "mesh" in only:
            bench_mesh(rows)
    finally:
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
