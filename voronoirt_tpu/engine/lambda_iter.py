"""NLTE Lambda-iteration engine (L4).

Reference parity: src/lambda_iteration.jl -- J_lambda_regular (:1-58),
J_lambda_voronoi (:60-113), Lambda_regular (:116-205), Lambda_voronoi
(:207-297), criterion (:299-349).

Iteration scheme (identical to the reference):
  * LTE populations, continuum extinction at line centre, destruction
    probability eps(lam0) and collisional rates C are computed once and
    FROZEN for the whole iteration (lambda_iteration.jl:124-154 -- the
    reference's "fidelity traps"; SURVEY.md §7).
  * Each iteration: damping(gamma(populations)) -> per-angle Voigt
    profiles with line-of-sight velocity (-k) -> alpha_tot ->
    formal solution for every (angle, wavelength) -> J = sum of weighted
    sweeps -> S = (1 - eps) J + eps B -> radiative rates R(J) ->
    statistical equilibrium -> revised populations.
  * Convergence: max over wavelengths of max relative S change,
    NaN-checked, vs cfg.eps with cfg.maxiter cap.

Design: wavelengths are a vectorized batch axis through the sweep
(the reference forks Julia threads per wavelength,
lambda_iteration.jl:30,91); angles are a serial loop of statically
planned sweeps locally and a sharded mesh axis in parallel runs
(parallel/mesh.py).  All heavy math is jitted; the outer while loop,
convergence print and checkpointing stay on the host like the reference.
"""

from __future__ import annotations

import dataclasses
import os
import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..config import Config
from .. import memory
from ..quadrature import get_quadrature
from ..physics.planck import B_lambda
from ..physics.atom import (alpha_line, compute_profile, destruction,
                            line_of_sight_velocity)
from ..physics.broadening import gamma_constant, damping
from ..physics.lte import lte_populations
from ..physics.opacity import alpha_absorption, alpha_scattering
from ..physics.rates import calculate_R, calculate_C
from ..physics.stateq import get_revised_populations
from ..solvers.sweep_regular import (build_plan, sweep as sweep_regular,
                                     group_plans, sweep_group_J,
                                     flip_field)
from ..solvers.sweep_voronoi import (_DONATE, share_plan_shapes,
                                     sweep_voronoi, sweep_voronoi_t)


@dataclasses.dataclass
class NLTEResult:
    J: np.ndarray
    S: np.ndarray
    alpha_cont: np.ndarray
    populations: np.ndarray
    convergence: list
    iterations: int
    converged: bool
    timings: list


# ------------------------------------------------------------- setup


def frozen_setup(line, temperature, electron_density, hydrogen_density,
                 cfg: Config):
    """LTE pops, alpha_cont(lam0), eps(lam0), C, B_0 -- all frozen.

    Mirrors lambda_iteration.jl:124-154 / :216-247.
    """
    from ..physics.opacity import warn_charge_inconsistency
    warn_charge_inconsistency(temperature, electron_density,
                              hydrogen_density)
    lte = lte_populations(line, temperature, electron_density,
                          hydrogen_density)
    a_cont = alpha_absorption(line.lam0, temperature, electron_density,
                              lte[..., 0] + lte[..., 1], lte[..., 2])
    a_cont = a_cont + alpha_scattering(line.lam0, electron_density,
                                       lte[..., 0])
    eps = destruction(lte, electron_density, temperature, line,
                      boost=cfg.boost)
    C = calculate_C(electron_density, temperature, lte, boost=cfg.boost)
    lam = jnp.asarray(line.lam)
    B0 = B_lambda(lam.reshape((-1,) + (1,) * temperature.ndim),
                  temperature[None])
    return lte, a_cont, eps, C, B0


@jax.jit
def _damping_lambda(line, temperature, n_neutral, electron_density,
                    gamma_natural):
    g = gamma_constant(line, temperature, n_neutral, electron_density,
                       gamma_natural)
    lam = jnp.asarray(line.lam).reshape((-1,) + (1,) * temperature.ndim)
    return damping(g[None], lam, line.dlamD[None])


@jax.jit
def _gamma_cell(line, temperature, n_neutral, electron_density,
                gamma_natural):
    """Per-cell damping rate gamma (lambda-independent)."""
    return gamma_constant(line, temperature, n_neutral, electron_density,
                          gamma_natural)


@jax.jit
def _damping_chunk(line, g_cell, lam_c):
    """damping for one lambda chunk from the per-cell gamma -- the
    production-scale path that never materializes the full
    (nlam, n) damping cube (1.3 GB at 3.5e6 sites)."""
    lam = lam_c.reshape((-1,) + (1,) * g_cell.ndim)
    return damping(g_cell[None], lam, line.dlamD[None])


@jax.jit
def _alpha_tot(line, lam, damping_lam, v_los, populations, alpha_cont):
    """alpha_line(profile(angle)) + alpha_cont for wavelengths `lam`."""
    profile = compute_profile(line, lam, damping_lam, v_los)
    a_line = alpha_line(line, profile, populations[..., 1],
                        populations[..., 0])
    return a_line + alpha_cont[None]


def _alpha_tot_g_impl(line, lam, g_cell, v_los, populations,
                      alpha_cont):
    """_alpha_tot with the damping chunk computed from the per-cell
    gamma: no (B, n) damping array is resident between directions
    (recomputing the damping is ~20 flops/point against the read of a
    materialized chunk)."""
    lamr = lam.reshape((-1,) + (1,) * g_cell.ndim)
    damp = damping(g_cell[None], lamr, line.dlamD[None])
    profile = compute_profile(line, lam, damp, v_los)
    a_line = alpha_line(line, profile, populations[..., 1],
                        populations[..., 0])
    return a_line + alpha_cont[None]


@jax.jit
def _alpha_tot_g_T(line, lam, g_cell, v_los, populations, alpha_cont):
    """_alpha_tot_g_impl emitted directly in the site-major (n, B) layout
    the Voronoi sweeps consume: the transpose fuses into the one
    compiled program, so the (B, n) intermediate never lands in HBM
    (an eager a_tot.T held both layouts -- 2.56 GB of transient per
    direction at 3.5e6 sites x 91 lambda)."""
    return _alpha_tot_g_impl(line, lam, g_cell, v_los, populations,
                             alpha_cont).T


@jax.jit
def _alpha_tot_g_t(line, lam, g_cell, v_los, populations, alpha_cont):
    """_alpha_tot_g_impl emitted in the z-major (nz, B, nx, ny) layout the
    regular sweeps consume (same both-layouts-transient argument as
    _alpha_tot_g_T: 1.46 GB per angle at the production shape)."""
    return jnp.swapaxes(_alpha_tot_g_impl(line, lam, g_cell, v_los,
                                          populations, alpha_cont),
                        0, 1)


def _lambda_chunks(n_lambda, chunk):
    """Slices covering the lambda axis in blocks of `chunk` (last block
    may be smaller -> at most two compiled chunk shapes)."""
    if not chunk or chunk >= n_lambda:
        return [slice(0, n_lambda)]
    return [slice(i, min(i + chunk, n_lambda))
            for i in range(0, n_lambda, chunk)]


def _maybe_slice(a, sl):
    """a[sl], skipping the dispatch when sl covers the whole leading
    axis: a full-range a[sl] still emits a device slice op whose output
    duplicates the array (1.28 GB per call at 3.5e6 sites x 91 lambda
    in the single-chunk production configuration)."""
    if sl.start == 0 and sl.stop >= a.shape[0]:
        return a
    return a[sl]


@partial(jax.jit, donate_argnums=(0,) if _DONATE else ())
def _write_rows(buf, chunk, start):
    """Donated in-place write of a lambda chunk into the J buffer
    (chunk assembly by concatenate would double-buffer 1.3 GB at
    production scale; without donation input+output J buffers are both
    live across the call -- 2.6 GB at 3.5e6 sites x 91 lambda).  The
    callers rebind J_buf, dropping their reference as donation
    requires."""
    return jax.lax.dynamic_update_slice(
        buf, chunk, (start,) + (0,) * (buf.ndim - 1))


def _sync_interval(nbytes, budget=None):
    """Backpressure cadence for the angle loop: JAX allocates every
    enqueued sweep's OUTPUT buffer at dispatch time, so an unthrottled
    12-angle loop at (91, 3.5e6) holds 12 x 1.28 GB of not-yet-consumed
    intensities.  The loop waits for the device every `interval` angles,
    sized so in-flight outputs stay under `budget` (default: the
    device-derived memory.inflight_bytes) and small problems never
    wait."""
    if budget is None:
        budget = memory.inflight_bytes()
    return max(1, int(budget // max(nbytes, 1)))


def _drain(x):
    """Wait until the device has produced x."""
    jax.block_until_ready(x)


@partial(jax.jit, donate_argnums=(0,) if _DONATE else ())
def _accum(J, I, w):
    """Donated fused J += w * I (the eager two-op form holds an extra
    (B, n) temporary -- 1.3 GB at production scale; without donation
    the input and output J accumulators are both live across every
    angle).  Callers rebind J, dropping their reference."""
    return J + w * I


@jax.jit
def _update_S(line, eps, J, B0):
    return (1.0 - eps)[None] * J + eps[None] * B0


@partial(jax.jit, donate_argnums=(1,))
def _s_update_stream(line, S, Jc, eps, T, lam_c, start):
    """Streamed S update: read the S_old chunk out of the (donated)
    full S buffer, form S_new = (1-eps) J + eps B with the Planck
    chunk recomputed in-jit (a resident full B0 cube is 5.13 GB at the
    production regular shape), fold the convergence-criterion partial
    max, and write S_new back in place.  Returns (S, partial_max)."""
    size = Jc.shape[0]
    idx = (start,) + (0,) * (S.ndim - 1)
    S_old_c = jax.lax.dynamic_slice(
        S, idx, (size,) + tuple(S.shape[1:]))
    B0_c = B_lambda(lam_c.reshape((-1,) + (1,) * T.ndim), T[None])
    S_new_c = ((1.0 - eps)[None] * Jc + eps[None] * B0_c).astype(S.dtype)
    denom = jnp.where(S_new_c != 0.0, S_new_c, 1.0)
    m = jnp.max(jnp.abs(S_new_c - S_old_c) / jnp.abs(denom))
    return jax.lax.dynamic_update_slice(S, S_new_c, idx), m


@partial(jax.jit, static_argnames=("r0", "compat"),
         donate_argnums=(1,))
def _rates_accum(line, acc, carry, Jc, r0, g_cell, lte, T, compat):
    """Accumulate one lambda chunk's radiative-rate contributions
    (physics.rates.calculate_R_chunk); acc is donated.  carry is the
    previous chunk's last J row (so boundary pairs integrate exactly
    once; None for the first chunk, where r0 is the true start)."""
    from ..physics.rates import calculate_R_chunk
    J_blk = Jc if carry is None else jnp.concatenate([carry, Jc], 0)
    return calculate_R_chunk(line, acc, J_blk, r0, g_cell, lte, T,
                             compat=compat)


@partial(jax.jit, static_argnames=("compat",))
def _rates_and_populations(line, J, damping_lam, lte, C, temperature,
                           hydrogen_density, compat):
    R = calculate_R(line, J, damping_lam, lte, temperature, compat=compat)
    pops = get_revised_populations(R, C, hydrogen_density)
    return pops


@partial(jax.jit, static_argnames=("compat",))
def _rates_slab(line, J_sl, g_sl, lte_sl, C_sl, T_sl, nH_sl, compat):
    """One site-slab of rates + SE with damping recomputed in-jit, so
    the (nlam, slab) Voigt/sigma/integrand temporaries stay bounded
    (the regular production bench's rates_fused pattern)."""
    lam = jnp.asarray(line.lam).reshape((-1,) + (1,) * T_sl.ndim)
    damp = damping(g_sl[None], lam, line.dlamD[None])
    R = calculate_R(line, J_sl, damp, lte_sl, T_sl, compat=compat)
    return get_revised_populations(R, C_sl, nH_sl)


def _rates_and_populations_slabbed(line, J, g_cell, lte, C, temperature,
                                   hydrogen_density, compat, site_chunk):
    """Stream the rates/SE update over site slabs (production scale:
    3.5e6 sites x 91 lambda cannot hold the full damping + sigma
    temporaries next to J).  Pointwise in space, so slab equality with
    the all-at-once path is exact."""
    n = temperature.shape[0]
    outs = []
    for s0 in range(0, n, site_chunk):
        sl = slice(s0, min(s0 + site_chunk, n))
        outs.append(_rates_slab(
            dataclasses.replace(line, dlamD=line.dlamD[sl]), J[:, sl],
            g_cell[sl], lte[sl], {k: v[sl] for k, v in C.items()},
            temperature[sl], hydrogen_density[sl], compat))
        # backpressure: wait for every fourth slab so in-flight
        # temporaries stay bounded
        if len(outs) % 4 == 0:
            _drain(outs[-1])
    return jnp.concatenate(outs, axis=0)


def _criterion(S_new, S_old):
    """max over lam of max |1 - S_old/S_new| (lambda_iteration.jl:299-349).

    Identical to the reference where S_new != 0; cells where S_new
    underflows to exactly 0 (float32: B_lambda at the 22.8 nm bf edge in
    cold cells is ~1e-45) compare by absolute difference instead --
    otherwise 0/0 = NaN would abort the float32 loop at iteration 0.
    """
    denom = jnp.where(S_new != 0.0, S_new, 1.0)
    diff = jnp.max(jnp.abs(S_new - S_old) / jnp.abs(denom))
    return float(diff)


# --------------------------------------------------------- regular grid


class RegularEngine:
    """Lambda iteration on the regular grid.

    Field layout: (nlam, nz, nx, ny); sweeps run transposed to
    (nz, nlam, nx, ny).
    """

    def __init__(self, atmos, line, cfg: Config, quadrature=None):
        self.atmos = atmos
        self.line = line
        self.cfg = cfg
        self.quad = get_quadrature(quadrature or cfg.quadrature)
        self.plans = []
        z = np.asarray(atmos.z)
        for i in range(self.quad.n_angles):
            k = self.quad.k[i]
            up = bool(self.quad.is_up[i])
            self.plans.append(build_plan(k, z, atmos.dx, atmos.dy, up))
        # mirror-quadrant angles share one batched sweep (the marching
        # kernels are latency-bound: a group of P angles runs for ~the
        # cost of one); singleton groups keep the per-angle path.
        # Group size is capped so the P per-angle extinction fields +
        # their stacked copy (the batched sweep's execution temps, ~6x
        # the stack) fit the device next to the resident chunk fields.
        max_group = cfg.group_max_angles
        if max_group is None and cfg.lambda_chunk:
            chunk_b = (np.dtype(cfg.sweep_dtype).itemsize
                       * cfg.lambda_chunk
                       * int(np.prod(atmos.temperature.shape)))
            max_group = max(1, memory.group_stack_bytes() // chunk_b)
        self.plan_groups = group_plans(self.quad.k, self.quad.is_up, z,
                                       atmos.dx, atmos.dy,
                                       max_group=max_group)
        self.T = jnp.asarray(atmos.temperature)
        self.ne = jnp.asarray(atmos.electron_density)
        self.nH = jnp.asarray(atmos.hydrogen_populations)
        self.v = jnp.asarray(atmos.velocity_zxy())
        (self.lte, self.a_cont, self.eps, self.C,
         self.B0) = frozen_setup(line, self.T, self.ne, self.nH, cfg)

    def compute_J(self, S, populations, damping_lam=None):
        """J accumulation over the quadrature (J_lambda_regular).

        With cfg.lambda_chunk set, wavelengths stream in blocks through
        profile -> alpha -> sweep -> J, bounding peak memory.  With
        parallel.distribute_angles applied, each device owns a subset of
        the quadrature directions (parallel/angles.py).  Mirror-quadrant
        angle groups (plan_groups) run as single batched sweeps unless
        angle MPMD or Bezier interpolation asks for per-angle sweeps.

        damping_lam=None computes damping per lambda chunk from the
        per-cell gamma (never the full (nlam, nz, nx, ny) cube).
        """
        from ..parallel import angles as _ang
        line, quad = self.line, self.quad
        devs = getattr(self, "angle_devices", None)
        lam = jnp.asarray(line.lam)
        chunks = _lambda_chunks(line.n_lambda, self.cfg.lambda_chunk)
        g_cell = None
        if damping_lam is None:
            g_cell = _gamma_cell(line, self.T,
                                 populations[..., 0] + populations[..., 1],
                                 self.ne, self.cfg.gamma_natural)
            if devs:
                damping_lam = _damping_lambda(
                    line, self.T,
                    populations[..., 0] + populations[..., 1],
                    self.ne, self.cfg.gamma_natural)
        grouped = (not devs
                   and self.cfg.formal_interpolation == "linear"
                   and any(len(g) > 1 for g in self.plan_groups))
        J_buf = None
        if len(chunks) > 1:
            J_buf = jnp.zeros((line.n_lambda,) + S.shape[1:], S.dtype)
        for sl in chunks:
            fused_damp = damping_lam is None and not devs
            if fused_damp:
                damp_sl = None      # computed in-jit per direction
            elif damping_lam is not None:
                damp_sl = damping_lam[sl]
            else:
                damp_sl = _damping_chunk(line, g_cell, lam[sl])
            sync_every = _sync_interval(
                S.dtype.itemsize * (sl.stop - sl.start)
                * int(np.prod(S.shape[1:])))
            if grouped:
                Jc = self._J_chunk_grouped(S[sl], populations,
                                           damp_sl, lam[sl],
                                           g_cell=g_cell)
                if J_buf is None:
                    return Jc
                J_buf = _write_rows(J_buf, Jc, sl.start)
                continue
            if devs:
                state = _ang.broadcast_state(
                    devs, S=S[sl], damping=damp_sl,
                    populations=populations, lam=lam[sl])
                partials = {}
            else:
                Jc = jnp.zeros_like(S[sl])
            for i in range(quad.n_angles):
                k = quad.k[i]
                plan = self.plans[i]
                if devs:
                    d = _ang.angle_device(self, i)
                    st, dst = state[d], self._angle_static[d]
                    v, a_cont, T_bot = (dst["v"], dst["a_cont"],
                                        dst["T_bottom"])
                    S_c, damp_c, pops_c, lam_c = (st["S"], st["damping"],
                                                  st["populations"],
                                                  st["lam"])
                else:
                    v, a_cont, T_bot = self.v, self.a_cont, self.T[0]
                    S_c, damp_c, pops_c, lam_c = (S[sl], damp_sl,
                                                  populations, lam[sl])
                v_los = line_of_sight_velocity(v, -k)
                if fused_damp and damp_c is None:
                    a_t = _alpha_tot_g_t(line, lam_c, g_cell, v_los,
                                         pops_c, a_cont)
                else:
                    a_t = jnp.swapaxes(
                        _alpha_tot(line, lam_c, damp_c, v_los,
                                   pops_c, a_cont), 0, 1)
                S_t = jnp.swapaxes(S_c, 0, 1)     # (nz, chunk, nx, ny)
                if plan.up:
                    I0 = B_lambda(lam_c[:, None, None], T_bot[None])
                else:
                    I0 = jnp.zeros_like(S_c[:, 0])
                I = sweep_regular(plan, S_t, a_t, I0,
                                  n_sweeps=self.cfg.n_sweeps,
                                  interpolation=self.cfg.formal_interpolation)
                if devs:
                    _ang.partial_accumulate(
                        partials, d, quad.weights[i] * jnp.swapaxes(I, 0, 1))
                else:
                    Jc = _accum(Jc, jnp.swapaxes(I, 0, 1),
                                jnp.asarray(quad.weights[i], Jc.dtype))
                    if (i + 1) % sync_every == 0:
                        _drain(Jc)
            if devs:
                Jc = _ang.reduce_partials(partials,
                                          _ang.target_device(S))
            if J_buf is None:
                return Jc
            J_buf = _write_rows(J_buf, Jc, sl.start)
        return J_buf

    def _J_chunk_grouped(self, S_c, populations, damp_c, lam_c,
                         g_cell=None):
        """One lambda chunk of J with mirror-angle groups batched.

        Per group: compute each angle's per-angle extinction, flip it to
        the canonical quadrant, stack along the batch axis, run ONE
        sweep, unflip, and accumulate the quadrature-weighted sum.

        damp_c=None (with g_cell given) computes the damping chunk
        in-jit per direction (_alpha_tot_g_t) -- no resident (B, ...)
        damping array.
        """
        line, quad = self.line, self.quad

        def a_t_for(k):
            """Per-angle extinction, already in the z-major sweep
            layout (fused transpose when the per-cell-gamma path is
            active)."""
            v_los = line_of_sight_velocity(self.v, -k)
            if damp_c is None:
                return _alpha_tot_g_t(line, lam_c, g_cell, v_los,
                                      populations, self.a_cont)
            return jnp.swapaxes(
                _alpha_tot(line, lam_c, damp_c, v_los,
                           populations, self.a_cont), 0, 1)

        T_bottom = self.T[0]
        Jc = jnp.zeros_like(S_c)
        S_t = jnp.swapaxes(S_c, 0, 1)        # (nz, chunk, nx, ny)
        B = S_t.shape[1]
        # backpressure between groups: each batched sweep allocates its
        # P per-angle extinctions + stack + output at dispatch; at
        # production chunks (>1 GB per group) an undrained loop holds
        # every group's working set at once and OOMs
        chunk_b = S_c.dtype.itemsize * int(np.prod(S_c.shape))
        drain_groups = chunk_b * max(
            len(g) for g in self.plan_groups) > (1 << 30)
        for group in self.plan_groups:
            if len(group) == 1:
                (i, _, _) = group[0]
                k = quad.k[i]
                plan = self.plans[i]
                a_t = a_t_for(k)
                if plan.up:
                    I0 = B_lambda(lam_c[:, None, None], T_bottom[None])
                else:
                    I0 = jnp.zeros_like(S_c[:, 0])
                I = sweep_regular(plan, S_t, a_t, I0,
                                  n_sweeps=self.cfg.n_sweeps)
                Jc = Jc + quad.weights[i] * jnp.swapaxes(I, 0, 1)
                continue
            a_list, I0_list = [], []
            for (i, plan_c, (fx, fy, fz)) in group:
                k = quad.k[i]
                a_list.append(a_t_for(k))
                # BC follows the ORIGINAL direction (fz = originally
                # down, z-flip-canonicalized): up = hot bottom plane,
                # down = dark top (lambda_iteration.jl:38-52)
                if not fz:
                    I0 = B_lambda(lam_c[:, None, None], T_bottom[None])
                else:
                    I0 = jnp.zeros_like(S_c[:, 0])
                I0_list.append(I0)
            plans = tuple(p for (_, p, _) in group)
            # flip + stack + batched sweep + weighted reduced emission
            # all inside one jit: per-group stacks are XLA execution-time
            # temporaries and the full P*B intensity cube never lands in
            # HBM -- the production grids need this headroom
            I_g = sweep_group_J(
                plans, S_t, tuple(a_list), tuple(I0_list),
                jnp.asarray([quad.weights[i] for (i, _, _) in group],
                            S_t.dtype),
                n_sweeps=self.cfg.n_sweeps,
                flips=tuple(f for (_, _, f) in group))
            Jc = Jc + jnp.swapaxes(I_g, 0, 1)
            if drain_groups:
                _drain(Jc)
        return Jc

    def damping_lam(self, populations):
        return _damping_lambda(self.line, self.T,
                               populations[..., 0] + populations[..., 1],
                               self.ne, self.cfg.gamma_natural)

    def bottom_boundary(self):
        lam = jnp.asarray(self.line.lam)
        return B_lambda(lam[:, None, None], self.T[0][None])

    def iterate_streamed(self, S, populations):
        """One Lambda iteration, fully lambda-streamed: each chunk
        flows J -> rate-integral accumulation -> in-place S update (+
        criterion partial), so no full J cube, no second S buffer and
        no Planck cube are ever resident -- 3 x 5.13 GB saved at the
        production 215x256x256 x 91 shape.  S is DONATED (overwritten
        chunk-wise after each chunk's sweep has consumed it).  Returns
        (S_new, pops_new,
        criterion_diff).  Streamed rates == calculate_R up to float
        addition order (tests/test_rates_stream.py); the angle-MPMD
        path is not supported here (use the standard loop)."""
        from ..physics.stateq import get_revised_populations
        line, cfg = self.line, self.cfg
        lam = jnp.asarray(line.lam)
        chunks = _lambda_chunks(line.n_lambda, cfg.lambda_chunk)
        g_cell = _gamma_cell(line, self.T,
                             populations[..., 0] + populations[..., 1],
                             self.ne, cfg.gamma_natural)
        acc = carry = None
        diff = 0.0
        for ci, sl in enumerate(chunks):
            Jc = self._J_chunk_grouped(_maybe_slice(S, sl), populations,
                                       None, lam[sl], g_cell=g_cell)
            r0 = sl.start if ci == 0 else sl.start - 1
            acc = _rates_accum(line, acc, carry, Jc, r0, g_cell,
                               self.lte, self.T, cfg.compat)
            carry = Jc[-1:]
            S, m = _s_update_stream(line, S, Jc, self.eps, self.T,
                                    lam[sl], sl.start)
            diff = max(diff, float(m))   # readback = backpressure
        pops = get_revised_populations(acc, self.C, self.nH)
        return S, pops, diff

    def run(self, checkpoint=None):
        if self.cfg.stream_rates:
            return _run_iteration_streamed(self, checkpoint)
        return _run_iteration(self, checkpoint)


# --------------------------------------------------------- voronoi grid


class VoronoiEngine:
    """Lambda iteration on the irregular grid.

    Field layout: (nlam, n_sites).
    """

    def __init__(self, sites, line, cfg: Config, quadrature=None,
                 plans=None):
        """plans: optionally inject pre-built per-direction plans (same
        order as the quadrature) -- lets callers time/build the host
        plan construction separately from the device physics setup,
        and reuse one plan set for several engines."""
        self.sites = sites
        self.line = line
        self.cfg = cfg
        self.quad = get_quadrature(quadrature or cfg.quadrature)
        self.plans = list(plans) if plans is not None else \
            self.build_plans(sites, self.quad, cfg)
        # pad per-direction slot shapes to group maxima: one compiled
        # sweep per stage-structure group instead of one per direction
        share_plan_shapes(self.plans, cfg.n_sweeps)
        self.T = jnp.asarray(sites.temperature)
        self.ne = jnp.asarray(sites.electron_density)
        self.nH = jnp.asarray(sites.hydrogen_populations)
        self.v = jnp.asarray(sites.velocity_zxy())
        (self.lte, self.a_cont, self.eps, self.C,
         self.B0) = frozen_setup(line, self.T, self.ne, self.nH, cfg)

    @staticmethod
    def build_plans(sites, quad, cfg: Config):
        """Host-side plan construction for every quadrature direction
        (disk-cached when cfg.cache_dir is set)."""
        from ..grid.voronoi import build_voronoi_plan
        plans = []
        for i in range(quad.n_angles):
            plans.append(build_voronoi_plan(
                sites, quad.k[i], bool(quad.is_up[i]),
                p=cfg.upwind_exponent, compat=cfg.compat,
                order=cfg.voronoi_order, n_sweeps=cfg.n_sweeps,
                cache_dir=cfg.cache_dir))
        return plans

    def compute_J(self, S, populations, damping_lam=None):
        """J accumulation over the quadrature (J_lambda_voronoi);
        lambda-chunked like the regular engine, angle-distributable like
        it too (parallel/angles.py).

        damping_lam=None computes damping per lambda chunk from the
        per-cell gamma instead of a full (nlam, n) cube -- bitwise the
        same values, 1.3 GB less resident at the production scale.
        """
        from ..parallel import angles as _ang
        line, quad = self.line, self.quad
        devs = getattr(self, "angle_devices", None)
        lam = jnp.asarray(line.lam)
        chunks = _lambda_chunks(line.n_lambda, self.cfg.lambda_chunk)
        g_cell = None
        if damping_lam is None:
            g_cell = _gamma_cell(line, self.T,
                                 populations[..., 0] + populations[..., 1],
                                 self.ne, self.cfg.gamma_natural)
            if devs:        # MPMD broadcast wants the materialized cube
                damping_lam = _damping_lambda(
                    line, self.T,
                    populations[..., 0] + populations[..., 1],
                    self.ne, self.cfg.gamma_natural)
        J_buf = None
        if len(chunks) > 1:
            J_buf = jnp.zeros((line.n_lambda,) + S.shape[1:], S.dtype)
        for sl in chunks:
            fused_damp = damping_lam is None and not devs
            if fused_damp:
                damp_sl = None      # computed in-jit per direction
            elif damping_lam is not None:
                damp_sl = damping_lam[sl]
            else:
                damp_sl = _damping_chunk(line, g_cell, lam[sl])
            sync_every = _sync_interval(
                S.dtype.itemsize * (sl.stop - sl.start)
                * int(np.prod(S.shape[1:])))
            if devs:
                state = _ang.broadcast_state(
                    devs, S=S[sl], damping=damp_sl,
                    populations=populations, lam=lam[sl])
                partials = {}
            else:
                # site-major layout through the sweeps: S transposed
                # once per chunk, each angle's extinction emitted
                # directly in (n, B) -- no transposes or full-range
                # slices inside the per-direction executions
                S_T = _maybe_slice(S, sl).T
                Jc_T = jnp.zeros_like(S_T)
            for i in range(quad.n_angles):
                k = quad.k[i]
                plan = self.plans[i]
                if devs:
                    d = _ang.angle_device(self, i)
                    st, dst = state[d], self._angle_static[d]
                    v, a_cont, T_d = dst["v"], dst["a_cont"], dst["T"]
                    S_c, damp_c, pops_c, lam_c = (st["S"], st["damping"],
                                                  st["populations"],
                                                  st["lam"])
                else:
                    v, a_cont, T_d = self.v, self.a_cont, self.T
                    damp_c, pops_c, lam_c = (damp_sl, populations,
                                             lam[sl])
                v_los = line_of_sight_velocity(v, -k)
                if plan.up:
                    I0 = B_lambda(lam_c[:, None], T_d[plan.bc_sites][None])
                else:
                    I0 = jnp.zeros((lam_c.shape[0],
                                    len(plan.bc_sites)), S.dtype)
                if devs:
                    a_tot = _alpha_tot(line, lam_c, damp_c, v_los,
                                       pops_c, a_cont)
                    I = sweep_voronoi(plan, S_c, a_tot, I0,
                                      n_sweeps=self.cfg.n_sweeps,
                                      relax_tol=self.cfg.voronoi_relax_tol)
                    _ang.partial_accumulate(partials, d,
                                            quad.weights[i] * I)
                else:
                    if fused_damp:
                        a_tot_T = _alpha_tot_g_T(line, lam_c, g_cell,
                                                 v_los, pops_c, a_cont)
                    else:
                        a_tot_T = _alpha_tot(line, lam_c, damp_c,
                                             v_los, pops_c, a_cont).T
                    if sync_every == 1:
                        # production scale (the chunk alone trips the
                        # 1 GB in-flight budget): serialize the phases
                        # within the direction too -- the sweep's
                        # dispatch-time output allocations must not
                        # stack on the extinction program's
                        _drain(a_tot_T)
                    I_T = sweep_voronoi_t(
                        plan, S_T, a_tot_T, I0,
                        n_sweeps=self.cfg.n_sweeps,
                        relax_tol=self.cfg.voronoi_relax_tol)
                    del a_tot_T
                    Jc_T = _accum(Jc_T, I_T,
                                  jnp.asarray(quad.weights[i],
                                              Jc_T.dtype))
                    del I_T
                    if (i + 1) % sync_every == 0:
                        _drain(Jc_T)
                    if os.environ.get("VRT_TRACE_J"):
                        print(f"[J] dir {i} done t={time.time():.1f}",
                              flush=True)
            if devs:
                Jc = _ang.reduce_partials(partials,
                                          _ang.target_device(S))
            else:
                Jc = Jc_T.T
            if J_buf is None:
                return Jc
            J_buf = _write_rows(J_buf, Jc, sl.start)
        return J_buf

    def damping_lam(self, populations):
        return _damping_lambda(self.line, self.T,
                               populations[..., 0] + populations[..., 1],
                               self.ne, self.cfg.gamma_natural)

    def run(self, checkpoint=None):
        return _run_iteration(self, checkpoint)


# --------------------------------------------------------- outer loop


def _run_iteration(engine, checkpoint=None, start_iteration=0, S_init=None,
                   populations_init=None):
    """Host-side while loop: iterate until converged (Lambda_regular /
    Lambda_voronoi), checkpointing every iteration like the reference
    (lambda_iteration.jl:188-189,280-281)."""
    cfg = engine.cfg
    line = engine.line

    populations = (jnp.asarray(populations_init)
                   if populations_init is not None else engine.lte)
    S_new = jnp.asarray(S_init) if S_init is not None else engine.B0
    S_old = jnp.zeros_like(S_new)

    convergence = []
    timings = []
    J = None
    i = start_iteration
    while True:
        diff = _criterion(S_new, S_old)
        convergence.append(diff)
        if checkpoint is not None:
            checkpoint.write_convergence(i + 1, diff)
        if np.isnan(diff):
            print(f"NaN convergence at iteration {i}")
        if i > 0:
            print(f"   Rel. diff.: {diff}")
        print(f"Iteration {i + 1}...")
        if not (diff > cfg.eps and i < cfg.maxiter):
            break

        t0 = time.time()
        S_old = S_new
        # drop the previous iteration's J BEFORE the new J pass: at the
        # 3.5e6-site x 91-lambda scale the stale buffer is 1.28 GB held
        # through compute_J for nothing
        J = None
        if cfg.rates_site_chunk:
            # production-memory path: damping per lambda chunk inside
            # compute_J, rates streamed over site slabs -- never holds
            # the (nlam, n) damping cube next to J (bitwise-identical
            # values; tests/test_lambda_iteration.py pins equality)
            g_cell = _gamma_cell(
                line, engine.T,
                populations[..., 0] + populations[..., 1], engine.ne,
                cfg.gamma_natural)
            J = engine.compute_J(S_old, populations, None)
            S_new = _update_S(line, engine.eps, J, engine.B0)
            populations = _rates_and_populations_slabbed(
                line, J, g_cell, engine.lte, engine.C, engine.T,
                engine.nH, cfg.compat, cfg.rates_site_chunk)
        else:
            damping_lam = engine.damping_lam(populations)
            J = engine.compute_J(S_old, populations, damping_lam)
            S_new = _update_S(line, engine.eps, J, engine.B0)
            populations = _rates_and_populations(
                line, J, damping_lam, engine.lte, engine.C, engine.T,
                engine.nH, cfg.compat)
        jax.block_until_ready(populations)
        timings.append(time.time() - t0)

        if checkpoint is not None and (i % cfg.checkpoint_every == 0):
            # hand the jax.Arrays straight to the backend: Orbax writes
            # sharded arrays per-shard (each process saves only its
            # addressable shards on a multi-host mesh); the HDF5 backend
            # materializes numpy itself.  np.asarray here would raise on
            # a non-fully-addressable multi-host array.
            checkpoint.write_state(populations, S_new)
        i += 1

    converged = convergence[-1] <= cfg.eps
    print(("Converged in %d iterations" % i) if converged
          else "Did not converge inside scope")
    return NLTEResult(J=np.asarray(J) if J is not None else None,
                      S=np.asarray(S_new), alpha_cont=np.asarray(engine.a_cont),
                      populations=np.asarray(populations),
                      convergence=convergence, iterations=i,
                      converged=converged, timings=timings)


def _run_iteration_streamed(engine, checkpoint=None):
    """The host loop for cfg.stream_rates: per-iteration state is ONE
    full S buffer (donated through iterate_streamed) + populations.
    The first convergence entry of the standard loop,
    criterion(B0, 0), is identically 1.0 -- recorded as such.

    The engine's B0 is CONSUMED as the initial S (the streamed path
    recomputes Planck chunks in-jit), so a resident B0 cube does not
    sit next to the iteration state."""
    cfg = engine.cfg
    assert cfg.formal_interpolation == "linear", \
        "stream_rates supports the linear formal solution only"
    populations = engine.lte
    S = engine.B0
    engine.B0 = None
    convergence = [1.0]
    timings = []
    if checkpoint is not None:
        checkpoint.write_convergence(1, 1.0)
    print("Iteration 1...")
    i = 0
    diff = float("inf")
    while diff > cfg.eps and i < cfg.maxiter:
        t0 = time.time()
        S, populations, diff = engine.iterate_streamed(S, populations)
        jax.block_until_ready(populations)
        timings.append(time.time() - t0)
        convergence.append(diff)
        i += 1
        if np.isnan(diff):
            print(f"NaN convergence at iteration {i}")
        print(f"   Rel. diff.: {diff}")
        if checkpoint is not None:
            checkpoint.write_convergence(i + 1, diff)
            if (i - 1) % cfg.checkpoint_every == 0:
                checkpoint.write_state(populations, S)
        if diff > cfg.eps and i < cfg.maxiter:
            print(f"Iteration {i + 1}...")
    converged = convergence[-1] <= cfg.eps
    print(("Converged in %d iterations" % i) if converged
          else "Did not converge inside scope")
    return NLTEResult(J=None, S=np.asarray(S),
                      alpha_cont=np.asarray(engine.a_cont),
                      populations=np.asarray(populations),
                      convergence=convergence, iterations=i,
                      converged=converged, timings=timings)
