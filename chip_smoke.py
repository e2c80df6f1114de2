"""Smoke run of the NLTE Lambda-iteration on one NVIDIA GPU.

Drives the main path -- synthetic atmosphere -> RegularEngine /
VoronoiEngine -> Lambda-iteration with radiative rates and statistical
equilibrium -- at the reference's production widths (ul7n12 quadrature,
91 wavelengths = 51 bound-bound + 2 x 20 bound-free, float32,
compat="reference"; drivers/line_nlte.py) through the engines the
drivers use, and checks it on the card against the repo's plain
references.  Phases run in order in one process; each prints one line;
any failure exits non-zero.

  0  device: a GPU (no CPU fallback), its name and power limit, the JAX
     version, the compile cache, the memory budgets derived from it
  1  float64 oracle fixtures (tests/golden) on the card
  2  regular production grid 215x256x256, 3 lambda-streamed iterations
  3  Voronoi grid, 442,368 sites sampled (invNH_invT) from the same
     atmosphere, tessellated by the native library, 2 iterations in the
     reference's 'layer' order and 2 in the exact 'wavefront' order
     (relax stages with hoisted weights, cost-model row caps)
  4  iteration 1 of phases 2-3 in float32 against the same iteration in
     float64 (the plain reference) on the card
  5  the CUDA march kernel against the plain XLA march
  6  HDF5 checkpoint, crash and resume (when h5py is installed)

Usage:
  python chip_smoke.py               # one card, phases 0-6
  python chip_smoke.py --four-cards  # only the multi-card layouts,
                                     # each against the one-card result
The last line is {"ok": true, "device": {"platform", "kind", "count"}}.
"""

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "golden")

REG_SHAPE = (215, 256, 256)     # half-resolution Bifrost proportions
N_SITES = 442_368               # compare_line.jl:64-74 site count
NLAM_BB, NLAM_BF = 51, 20
QUADRATURE = "ul7n12"
ATMOS_SEED = 5
SITE_SEED = 2022

# float32 against the float64 plain reference.  Rounding along a
# 215-plane march with 3 Gauss-Seidel passes leaves ~1e-5 (the sound
# runs read <= 1.1e-5 on an H100); a result carrying bfloat16 rounding
# reads ~2e-3, so 1e-4 passes the one and fails the other -- the
# control printed beside each error is the float64 result rounded to
# bfloat16, and it must fail.  Errors are normwise per wavelength (S) or
# per level (populations): max|a32 - a64| / max|a64|.
F32_TOL = 1e-4


def say(name, **fields):
    print(f"{name}: {json.dumps(fields, default=_plain)}", flush=True)


def _plain(x):
    if isinstance(x, (np.integer,)):
        return int(x)
    if isinstance(x, (np.floating, np.ndarray)):
        return float(x)
    return str(x)


@contextlib.contextmanager
def quiet():
    """Engine progress prints go to stderr; stdout keeps one line per
    phase."""
    with contextlib.redirect_stdout(sys.stderr):
        yield


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out


# ------------------------------------------------------------- phase 0

def phase_device(n_cards):
    from voronoirt_tpu.platform import compile_cache_dir, setup
    try:
        setup(platform="gpu", x64=True)
    except RuntimeError as e:
        sys.exit(f"chip_smoke: no GPU backend: {e}")
    import jax
    from voronoirt_tpu import memory
    devs = jax.devices()
    if devs[0].platform != "gpu" or len(devs) < n_cards:
        sys.exit(f"chip_smoke: need {n_cards} GPU(s), have {devs}")
    for line in nvidia_smi():
        print(f"nvidia-smi: {line}", flush=True)
    say("phase 0 device", kind=devs[0].device_kind, count=len(devs),
        jax=jax.__version__, compile_cache=compile_cache_dir(),
        budgets_f32_91lam=memory.budgets(NLAM_BB + 2 * NLAM_BF, 4))
    return devs


# ------------------------------------------------------------- phase 1

def _max_rel(got, want, floor=0.0):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    denom = np.where(want == 0.0, 1.0, np.abs(want) + floor)
    rd = np.abs(got - want) / denom
    return float(np.max(np.where(want == 0.0, np.abs(got), rd)))


def _check(name, err, tol):
    if not err <= tol:
        raise AssertionError(f"{name}: error {err:.3e} above {tol:.1e}")
    return {"err": err, "tol": tol}


def phase_oracle():
    """Float64 fixtures on the card.  The CPU holds the sweep oracle at
    1e-12; the GPU's exp/log may differ in the last ulps and a
    Gauss-Seidel march compounds them, so 1e-10 here.  The NLTE chain
    and continuum goldens keep the CPU tests' own tolerances."""
    import jax.numpy as jnp
    from voronoirt_tpu.atmosphere import Atmosphere
    from voronoirt_tpu.config import Config
    from voronoirt_tpu.engine.lambda_iter import RegularEngine, VoronoiEngine
    from voronoirt_tpu.grid.voronoi import VoronoiSites
    from voronoirt_tpu.physics.atom import lyman_alpha_line
    from voronoirt_tpu.physics.opacity import (alpha_absorption,
                                               alpha_scattering)
    from voronoirt_tpu.solvers.sweep_regular import short_characteristics

    out = {}
    fx = np.load(os.path.join(GOLDEN, "regular_sweep_fixtures.npz"))
    worst = 0.0
    for case in ("up_xy", "dn_xy", "up_yz", "dn_yz", "up_xz", "dn_xz",
                 "up_mix", "dn_mix"):
        S = fx[f"{case}_S"]
        dx = 1.0 / S.shape[1]
        I = short_characteristics(fx[f"{case}_k"], S, fx[f"{case}_alpha"],
                                  fx[f"{case}_I0"], fx[f"{case}_z"], dx,
                                  dx, up=bool(fx[f"{case}_up"]),
                                  n_sweeps=3)
        worst = max(worst, _max_rel(I, fx[f"{case}_I"], 1e-12))
    out["sweep_8_cases"] = _check("sweep oracle", worst, 1e-10)

    fx = np.load(os.path.join(GOLDEN, "nlte_fixtures.npz"))
    cfg = Config(maxiter=3, eps=1e-30, quadrature="ul7n12", nlam_bb=9,
                 nlam_bf=4, compat="reference")
    keys = ((0, 1), (1, 0), (0, 2), (2, 0), (1, 2), (2, 1))

    def inject(eng, prefix):
        eng.a_cont = jnp.asarray(fx[f"{prefix}_alpha_cont"])
        eng.eps = jnp.asarray(fx[f"{prefix}_eps"])
        eng.C = {k: jnp.asarray(fx[f"{prefix}_C_{k[0]}{k[1]}"])
                 for k in keys}

    atmos = Atmosphere(**{f: fx[f"reg_atmos_{f}"] for f in (
        "z", "x", "y", "temperature", "electron_density",
        "hydrogen_populations", "velocity_z", "velocity_x",
        "velocity_y")})
    sites = VoronoiSites(bounds=tuple(fx["vor_bounds"]), **{
        f: fx[f"vor_sites_{f}"] for f in (
            "positions", "neighbours", "delaunay_lines", "layers_up",
            "layers_down", "temperature", "electron_density",
            "hydrogen_populations", "velocity_z", "velocity_x",
            "velocity_y")})
    with quiet():
        reg = RegularEngine(atmos, lyman_alpha_line(
            9, 4, np.asarray(atmos.temperature)), cfg)
        inject(reg, "reg")
        res_r = reg.run()
        vor = VoronoiEngine(sites, lyman_alpha_line(
            9, 4, np.asarray(sites.temperature)), cfg)
        inject(vor, "vor")
        res_v = vor.run()
    for tag, res in (("reg", res_r), ("vor", res_v)):
        for name, got, tol in (("J", res.J, 1e-8), ("S", res.S, 1e-8),
                               ("pops", res.populations, 1e-7)):
            out[f"nlte_{tag}_{name}"] = _check(
                f"NLTE {tag} {name}",
                _max_rel(got, fx[f"{tag}_{name}_2"]), tol)

    fx = np.load(os.path.join(GOLDEN, "alpha_cont_golden.npz"))
    T, n_e = jnp.asarray(fx["T"]), jnp.asarray(fx["n_e"])
    n_h1, n_p = jnp.asarray(fx["n_h1"]), jnp.asarray(fx["n_p"])
    worst = 0.0
    for i, lam in enumerate(fx["lambdas"]):
        worst = max(worst, _max_rel(
            alpha_absorption(float(lam), T, n_e, n_h1, n_p),
            fx[f"alpha_abs_{i}"]), _max_rel(
            alpha_scattering(float(lam), n_e, n_h1), fx[f"alpha_sca_{i}"]))
    out["alpha_cont"] = _check("alpha_cont golden", worst, 1e-10)
    say("phase 1 float64 oracle on the card", **out)


# ---------------------------------------------------------- engine runs

class FirstState:
    """Checkpoint stand-in: keeps a host copy of the state after the
    first iteration (the engines hand it to write_state)."""

    def __init__(self):
        self.S = self.populations = None

    def write_convergence(self, i, diff):
        pass

    def write_state(self, populations, S):
        if self.S is None:
            self.S = np.asarray(S)
            self.populations = np.asarray(populations)


def lambda_chunk_for(n_cells, itemsize, n_lambda, max_group=4):
    """Widest equal-size lambda chunk whose 4-angle group stack fits the
    device-derived group budget."""
    from voronoirt_tpu import memory
    widest = max(1, memory.group_stack_bytes()
                 // (max_group * itemsize * n_cells))
    n_chunks = math.ceil(n_lambda / widest)
    return math.ceil(n_lambda / n_chunks)


def make_config(dtype, maxiter, **kw):
    """The production configuration (drivers/line_nlte.py defaults)."""
    from voronoirt_tpu import Config
    return Config(eps=0.0, maxiter=maxiter, nlam_bb=NLAM_BB,
                  nlam_bf=NLAM_BF, quadrature=QUADRATURE,
                  compat="reference", dtype=dtype, **kw)


def run_regular(atmos, dtype, maxiter):
    """RegularEngine on the production path (--stream); returns the
    result, the first-iteration state and the timing split."""
    import jax.numpy as jnp
    from voronoirt_tpu.engine import RegularEngine
    from voronoirt_tpu.observability.metrics import CompileClock
    from voronoirt_tpu.physics import lyman_alpha_line
    n_cells = int(np.prod(atmos.temperature.shape))
    nlam = NLAM_BB + 2 * NLAM_BF
    chunk = lambda_chunk_for(n_cells, np.dtype(dtype).itemsize, nlam)
    cfg = make_config(dtype, maxiter, lambda_chunk=chunk,
                      stream_rates=True)
    first = FirstState()
    with CompileClock() as cc, quiet():
        t0 = time.time()
        line = lyman_alpha_line(NLAM_BB, NLAM_BF,
                                jnp.asarray(atmos.temperature))
        eng = RegularEngine(atmos, line, cfg)
        t_setup = time.time() - t0
        res = eng.run(checkpoint=first)
    timing = {"lambda_chunk": chunk, "max_group": max(
        len(g) for g in eng.plan_groups), "setup_s": t_setup,
        "first_iteration_s": res.timings[0], "compile_s": cc.seconds,
        "compiles": cc.compiles, "cache_hits": cc.cache_hits,
        "warm_iteration_s": (float(np.mean(res.timings[1:]))
                             if len(res.timings) > 1 else None)}
    return res, first, line, timing


def run_voronoi(sites, dtype, maxiter, plans=None, order="layer"):
    import jax.numpy as jnp
    from voronoirt_tpu import get_quadrature
    from voronoirt_tpu.engine import VoronoiEngine
    from voronoirt_tpu.observability.metrics import CompileClock
    from voronoirt_tpu.physics import lyman_alpha_line
    cfg = make_config(dtype, maxiter, voronoi_order=order)
    first = FirstState()
    timing = {}
    with CompileClock() as cc, quiet():
        if plans is None:
            t0 = time.time()
            plans = VoronoiEngine.build_plans(
                sites, get_quadrature(QUADRATURE), cfg)
            timing["plan_build_s"] = time.time() - t0
        t0 = time.time()
        line = lyman_alpha_line(NLAM_BB, NLAM_BF,
                                jnp.asarray(sites.temperature))
        eng = VoronoiEngine(sites, line, cfg, plans=plans)
        timing["setup_s"] = time.time() - t0
        res = eng.run(checkpoint=first)
    timing.update({
        "first_iteration_s": res.timings[0], "compile_s": cc.seconds,
        "compiles": cc.compiles, "cache_hits": cc.cache_hits,
        "warm_iteration_s": (float(np.mean(res.timings[1:]))
                             if len(res.timings) > 1 else None)})
    return res, first, plans, timing


def _finite(name, *arrays):
    for a in arrays:
        if not np.all(np.isfinite(a)):
            raise AssertionError(f"{name}: non-finite values")


def _memory():
    from voronoirt_tpu.observability.metrics import device_memory
    m = device_memory()
    return {"peak_bytes_in_use": m["peak_bytes_in_use"],
            "bytes_limit": m["bytes_limit"]}


# ------------------------------------------------------------- phase 2

def phase_regular(shape=REG_SHAPE, maxiter=3):
    import jax
    from voronoirt_tpu import synthetic_atmosphere
    jax.config.update("jax_enable_x64", False)
    t0 = time.time()
    atmos = synthetic_atmosphere(*shape, seed=ATMOS_SEED)
    t_host = time.time() - t0
    res, first, line, timing = run_regular(atmos, "float32", maxiter)
    if res.iterations != maxiter:
        raise AssertionError(f"regular: {res.iterations} iterations")
    _finite("regular S", res.S)
    _finite("regular populations", res.populations)
    edge = int(np.argmin(np.abs(np.asarray(line.lam) - 22.8e-9)))
    _finite("regular S at the 22.8 nm edge", res.S[edge])
    say("phase 2 regular", grid=list(shape), n_lambda=line.n_lambda,
        iterations=res.iterations, convergence=res.convergence,
        host_atmosphere_s=t_host,
        time_to_first_iteration_s=(t_host + timing["setup_s"]
                                   + timing["first_iteration_s"]),
        edge_lambda_m=float(line.lam[edge]), **timing, **_memory())
    return atmos, first


# ------------------------------------------------------------- phase 3

def ensure_native():
    """The native tessellation library, built if absent; the scipy
    fallback is not acceptable at production size."""
    from voronoirt_tpu.grid import neighbors
    lib = neighbors._load_lib() or neighbors.build_native()
    if lib is None:
        raise RuntimeError("native Voronoi library could not be built")


def make_sites(atmos, n_sites):
    from voronoirt_tpu.grid import build_sites, initialise_sites
    from voronoirt_tpu.grid.sampling import sample_sites
    ensure_native()
    t0 = time.time()
    pos = sample_sites(atmos, n_sites, density="invNH_invT",
                       seed=SITE_SEED)
    fields = initialise_sites(pos, atmos)
    t_sample = time.time() - t0
    bounds = (atmos.z[0], atmos.z[-1], atmos.x[0], atmos.x[-1],
              atmos.y[0], atmos.y[-1])
    t0 = time.time()
    sites = build_sites(pos, bounds, fields)
    return sites, {"sample_s": t_sample,
                   "tessellate_s": time.time() - t0}


def wavefront_schedule(plans, n_lambda, itemsize):
    """Row caps the cost model chose for the exact levels, and the relax
    stages whose lean weights are hoisted (memory.hoist_bytes)."""
    from voronoirt_tpu import memory
    from voronoirt_tpu.solvers.sweep_voronoi import (build_slot_plan,
                                                     hoisted_bytes)
    caps, hoisted = set(), []
    for p in plans:
        if p.exact_levels is not None:
            caps.add(int(p.exact_levels.shape[1]))
        for st in build_slot_plan(p).stages:
            if st.kind == "relax":
                hoisted.append(hoisted_bytes(st.L * st.W, st.repeats,
                                             n_lambda, itemsize))
    return {"row_caps": sorted(caps), "relax_stages": len(hoisted),
            "hoisted_stages": sum(1 for h in hoisted if h),
            "hoisted_bytes_max": max(hoisted, default=0),
            "hoist_budget_bytes": memory.hoist_bytes()}


def phase_voronoi(atmos, n_sites=N_SITES, maxiter=2):
    """Both sweep orders on one tessellation; returns the sites and, per
    order, the plans and the first-iteration state."""
    import jax
    jax.config.update("jax_enable_x64", False)
    sites, host = make_sites(atmos, n_sites)
    runs = {}
    for order in ("layer", "wavefront"):
        res, first, plans, timing = run_voronoi(sites, "float32", maxiter,
                                                order=order)
        if res.iterations != maxiter:
            raise AssertionError(f"voronoi {order}: {res.iterations} "
                                 f"iterations")
        _finite(f"voronoi {order} S", res.S)
        _finite(f"voronoi {order} populations", res.populations)
        host_s = sum(host.values()) + timing["plan_build_s"]
        extra = (wavefront_schedule(plans, res.S.shape[0], 4)
                 if order == "wavefront" else {})
        say(f"phase 3 voronoi {order}", n_sites=sites.n,
            iterations=res.iterations, convergence=res.convergence, **host,
            time_to_first_iteration_s=(host_s + timing["setup_s"]
                                       + timing["first_iteration_s"]),
            **extra, **timing, **_memory())
        runs[order] = (plans, first)
    return sites, runs


# ------------------------------------------------------------- phase 4

def _normwise(a32, a64, axis):
    """max over `axis` slices of max|a32 - a64| / max|a64|."""
    a32 = np.asarray(a32, np.float64)
    a64 = np.asarray(a64, np.float64)
    other = tuple(i for i in range(a64.ndim) if i != axis)
    scale = np.max(np.abs(a64), axis=other)
    diff = np.max(np.abs(a32 - a64), axis=other)
    return float(np.max(diff / np.where(scale > 0, scale, 1.0)))


def _bf16(a):
    """`a` rounded to bfloat16 (8 significant bits) and back."""
    import jax.numpy as jnp
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _against_f64(name, a32, a64, axis):
    """The float32 error against the float64 reference, held to F32_TOL,
    beside the control: the float64 result rounded to bfloat16, which
    the same check must reject."""
    control = _normwise(_bf16(a64), a64, axis)
    if not control > F32_TOL:
        raise AssertionError(f"{name}: bfloat16 control {control:.3e} "
                             f"does not exceed {F32_TOL:.1e}")
    return {**_check(name, _normwise(a32, a64, axis), F32_TOL),
            "control_bf16": control}


def matrix_products():
    """Modules of the device path (physics, solvers, engine) that
    contain a dot/einsum/matmul -- where TF32 could enter a float32
    run.  Host-side numpy in grid/ is not on the device."""
    import glob
    import re
    found = []
    for path in sorted(glob.glob(os.path.join(
            ROOT, "voronoirt_tpu", "*", "*.py"))):
        if os.path.basename(os.path.dirname(path)) not in (
                "physics", "solvers", "engine"):
            continue
        with open(path) as f:
            if re.search(r"\b(dot|einsum|matmul|tensordot|dot_general)"
                         r"\(| @ ", f.read()):
                found.append(os.path.relpath(path, ROOT))
    return found


def phase_f64(atmos, reg_first, sites, vor_runs):
    import jax
    jax.config.update("jax_enable_x64", True)
    out = {"matrix_products_on_device": matrix_products() or "none",
           "tol": F32_TOL}
    res, first, _, timing = run_regular(atmos, "float64", 1)
    out["regular_f64_iteration_s"] = timing["first_iteration_s"]
    out["regular_f64_lambda_chunk"] = timing["lambda_chunk"]
    out["regular_S"] = _against_f64("regular S f32 vs f64", reg_first.S,
                                    first.S, 0)
    out["regular_populations"] = _against_f64(
        "regular populations f32 vs f64", reg_first.populations,
        first.populations, 3)
    del res, first
    for order, (plans, vor_first) in vor_runs.items():
        res, first, _, timing = run_voronoi(sites, "float64", 1,
                                            plans=plans, order=order)
        tag = f"voronoi_{order}"
        out[f"{tag}_f64_iteration_s"] = timing["first_iteration_s"]
        out[f"{tag}_S"] = _against_f64(f"{tag} S f32 vs f64", vor_first.S,
                                       first.S, 0)
        out[f"{tag}_populations"] = _against_f64(
            f"{tag} populations f32 vs f64", vor_first.populations,
            first.populations, 1)
        del res, first
    say("phase 4 float32 vs float64 plain reference", **out)


# ------------------------------------------------------------- phase 5

def _timed(fn, *args, reps=5):
    import jax
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps, out


def phase_kernel(n=256, batches=(16, 91)):
    """One z-plane of the marching case: the CUDA march kernel against
    the plain XLA scan on the same coeff/const in float32 (<= 2e-5
    relative, the tolerance the old interpret-mode kernel test held) and
    against the float64 plain scan, for a single angle and for a batched
    4-angle mirror group (per-row f, r and centre selector)."""
    import jax
    import jax.numpy as jnp
    from voronoirt_tpu.solvers import march_cuda
    from voronoirt_tpu.solvers import sweep_regular as sr
    jax.config.update("jax_enable_x64", True)
    out = {}
    plan = sr.RegularPlan(k=(0, 0, 0), up=True, sign_x=-1, sign_y=1,
                          sxs=-1, sys=0, r_x=1.7, r_y=1.3, fy_line=0.3,
                          fx_line=0.6, segments=())
    for B in batches:
        for mode in ("angle", "group"):
            P = 1 if mode == "angle" else 4
            rng = np.random.default_rng(B + P)
            fields = [rng.uniform(lo, hi, (P * B, n, n)) for lo, hi in (
                (0.0, 2.0), (0.0, 2.0), (0.1, 1.0), (0.1, 1.0), (0.0, 1.0))]
            case, geom = "yz", None
            if P > 1:
                case = "xz"
                per_row = lambda *v: np.repeat(v, B)
                geom = {"f_line": per_row(0.1, 0.4, 0.6, 0.9)[:, None],
                        "r": per_row(1.1, 1.3, 1.7, 2.3)[:, None],
                        "c_prev": per_row(0.0, 1.0, 0.0, 1.0)[:, None, None]}

            def inputs(dtype):
                g = (None if geom is None else
                     {k: jnp.asarray(v, dtype) for k, v in geom.items()})
                a_p, a_c, s_p, s_c, i_p = (jnp.asarray(a, dtype)
                                           for a in fields)
                coeff, const, f_line, s_base = sr._march_plane_coefficients(
                    plan, case, jnp.asarray(0.35, dtype), i_p, a_c, a_p,
                    s_c, s_p, "cur", geom=g)
                return coeff, const, jnp.asarray(f_line, dtype), s_base

            coeff, const, f_line, s_base = inputs(jnp.float32)
            kernel = jax.jit(lambda c, k, f: march_cuda.march_lines(
                c, k, f, s_base, 3))
            scan = jax.jit(lambda c, k, f: sr._march_scan(
                c, k, f, s_base, 3))
            t_k, got = _timed(kernel, coeff, const, f_line)
            t_p, ref32 = _timed(scan, coeff, const, f_line)
            _, ref64 = _timed(scan, *inputs(jnp.float64)[:3], reps=1)
            tag = f"B{B}_{mode}"
            out[tag] = {
                "kernel_vs_plain_f32": _check(
                    f"march kernel {tag}", _max_rel(got, ref32, 1e-6),
                    2e-5)["err"],
                "kernel_vs_f64": _check(
                    f"march kernel {tag} vs f64",
                    _max_rel(got, ref64, 1e-6), 2e-5)["err"],
                "plain_f32_vs_f64": _max_rel(ref32, ref64, 1e-6),
                "kernel_s": t_k, "plain_s": t_p}
    say("phase 5 march kernel vs plain march", plane=[n, n], tol=2e-5,
        **out)


# ------------------------------------------------------------- phase 6

def phase_checkpoint():
    """HDF5 checkpoint, crash after iteration 2, resume; the resumed
    run must equal the uninterrupted one.  Needs h5py, which the card's
    machine need not have: then the phase says it did not run."""
    try:
        import h5py  # noqa: F401
    except ImportError:
        say("phase 6 checkpoint and resume", ran=False,
            reason="h5py is not installed")
        return
    import jax
    import jax.numpy as jnp
    from voronoirt_tpu import Config, synthetic_atmosphere
    from voronoirt_tpu.engine import RegularEngine
    from voronoirt_tpu.engine.checkpoint import CheckpointFile, recover
    from voronoirt_tpu.engine.lambda_iter import _run_iteration
    from voronoirt_tpu.physics import lyman_alpha_line
    jax.config.update("jax_enable_x64", True)
    out_dir = os.path.join(ROOT, ".cache", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    atmos = synthetic_atmosphere(nz=12, nx=8, ny=8, seed=2)
    cfg = Config(eps=0.0, maxiter=4, nlam_bb=5, nlam_bf=3, quadrature="n2")

    def engine():
        return RegularEngine(atmos, lyman_alpha_line(
            5, 3, jnp.asarray(atmos.temperature)), cfg)

    class CrashAfter:
        def __init__(self, inner, n):
            self.inner, self.n = inner, n

        def write_convergence(self, i, d):
            self.inner.write_convergence(i, d)

        def write_state(self, p, s):
            self.inner.write_state(p, s)
            self.n -= 1
            if self.n == 0:
                raise KeyboardInterrupt

    with quiet():
        full = _run_iteration(engine())
        eng = engine()
        path = os.path.join(out_dir, "crash.h5")
        ckpt = CheckpointFile(path)
        ckpt.create_regular(eng.line, atmos, cfg.maxiter)
        try:
            _run_iteration(eng, checkpoint=CrashAfter(ckpt, 2))
        except KeyboardInterrupt:
            pass
        resumed_from = CheckpointFile(path).resume_iteration()
        resumed = recover(engine(), path)
    say("phase 6 checkpoint and resume", ran=True,
        resumed_from=resumed_from,
        S=_check("resume S", _max_rel(resumed.S, full.S), 1e-8),
        populations=_check("resume populations", _max_rel(
            resumed.populations, full.populations), 1e-8))


# ---------------------------------------------------------- four cards

def four_cards(devices, shape=REG_SHAPE, n_sites=N_SITES):
    """The multi-card layouts at the widths of phases 2-3, each against
    the one-card result after one float32 iteration: regular
    ("lam", "y") mesh (the streamed production path), Voronoi
    ("lam", "site") mesh, Voronoi angle MPMD."""
    import jax
    import jax.numpy as jnp
    from voronoirt_tpu import get_quadrature, synthetic_atmosphere
    from voronoirt_tpu.engine import RegularEngine, VoronoiEngine
    from voronoirt_tpu.parallel import (distribute_angles, make_mesh,
                                        shard_regular, shard_voronoi)
    from voronoirt_tpu.physics import lyman_alpha_line
    from voronoirt_tpu.physics.atom import pad_line

    jax.config.update("jax_enable_x64", False)
    n, n_lam = len(devices), 2
    nlam = -(-(NLAM_BB + 2 * NLAM_BF) // n_lam) * n_lam

    def iterate(eng, shard=None):
        if shard is not None:
            shard(eng)
        t0 = time.time()
        with quiet():
            res = eng.run()
        _finite("four-card iteration", res.S, res.populations)
        return res.S, res.populations, time.time() - t0

    def compare(tag, ref, got):
        out = {"seconds": got[2], "one_card_seconds": ref[2]}
        for name, a, b in (("S", got[0], ref[0]),
                           ("populations", got[1], ref[1])):
            ax = 0 if name == "S" else a.ndim - 1
            out[name] = _check(f"{tag} {name}", _normwise(a, b, ax), 1e-5)
        return out

    results = {}
    atmos = synthetic_atmosphere(*shape, seed=ATMOS_SEED)
    line = pad_line(lyman_alpha_line(NLAM_BB, NLAM_BF,
                                     jnp.asarray(atmos.temperature)), nlam)
    chunk = lambda_chunk_for(int(np.prod(shape)), 4, nlam)
    cfg = make_config("float32", 1, lambda_chunk=chunk, stream_rates=True)
    ref = iterate(RegularEngine(atmos, line, cfg))
    mesh = make_mesh((n_lam, n // n_lam), ("lam", "y"), devices=devices)
    got = iterate(RegularEngine(atmos, line, cfg),
                  lambda e: shard_regular(e, mesh))
    results["regular_lam_y"] = compare("regular (lam, y)", ref, got)
    results["regular_lam_y"]["lambda_chunk"] = chunk
    del ref, got

    sites, _ = make_sites(atmos, n_sites - n_sites % n)
    vline = pad_line(lyman_alpha_line(NLAM_BB, NLAM_BF,
                                      jnp.asarray(sites.temperature)), nlam)
    cfg = make_config("float32", 1)
    with quiet():
        plans = VoronoiEngine.build_plans(
            sites, get_quadrature(QUADRATURE), cfg)
    ref = iterate(VoronoiEngine(sites, vline, cfg, plans=plans))
    mesh = make_mesh((n_lam, n // n_lam), ("lam", "site"), devices=devices)
    got = iterate(VoronoiEngine(sites, vline, cfg, plans=plans),
                  lambda e: shard_voronoi(e, mesh))
    results["voronoi_lam_site"] = compare("voronoi (lam, site)", ref, got)
    got = iterate(VoronoiEngine(sites, vline, cfg, plans=plans),
                  lambda e: distribute_angles(e, devices))
    results["voronoi_angle_mpmd"] = compare("voronoi angle MPMD", ref, got)
    say("four cards", cards=n, grid=list(shape), n_sites=sites.n,
        n_lambda=nlam, tol=1e-5, **results)


# ---------------------------------------------------------------- main

def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-card layouts on 4 GPUs")
    args = ap.parse_args()
    n_cards = 4 if args.four_cards else 1
    devs = phase_device(n_cards)
    if args.four_cards:
        four_cards(devs[:4])
    else:
        phase_oracle()
        atmos, reg_first = phase_regular()
        sites, vor_runs = phase_voronoi(atmos)
        phase_f64(atmos, reg_first, sites, vor_runs)
        phase_kernel()
        phase_checkpoint()
    d = devs[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devs)}}), flush=True)


if __name__ == "__main__":
    main()
