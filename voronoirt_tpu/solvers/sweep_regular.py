"""Regular-grid short-characteristics sweep.

Reference parity: src/characteristics.jl (short_characteristics_up/_down
and the six *_ray kernels).  Same numerics, different structure:

  * The reference stores periodic "ghost" cells and loops interior points
    (characteristics.jl:218,273-278 etc.).  Ghosts + interior loops are
    exactly a periodic domain, so this build drops ghosts and uses
    jnp.roll shifts on the physical (Nx, Ny) grid -- every stencil is a
    fixed-shape shifted-array expression XLA fuses on the VPU.
  * All direction-dependent geometry (plane case, stencil base shifts,
    interpolation fractions, path lengths) is compiled host-side into a
    static `RegularPlan` (SURVEY.md §7 "static index plans"), so the
    jitted sweep sees only fixed shapes and per-step scalars.
  * z marches via lax.scan carrying the previous plane.  The xy case
    (upwind fully in the previous plane, characteristics.jl:191-280) is
    one fused whole-plane update.  The yz/xz cases (in-plane dependency,
    characteristics.jl:383-718) replicate the reference's n_sweeps
    Gauss-Seidel passes as a lax.scan along the ordered axis with the
    orthogonal axis and the wavelength batch vectorized, carrying the
    reference's one-line buffer (I_upper/I_lower).
  * Wavelengths ride a leading batch axis B instead of Threads.@threads
    (lambda_iteration.jl:30).

Field layout: (nz, B, Nx, Ny); B is any batch (usually wavelength).
Boundary intensity I0: (B, Nx, Ny).

Reference quirks reproduced deliberately (validated against a
transliteration oracle that matches the published searchlight golden,
data/searchlight_data/I_160_45_regular.npy, to 2e-16):
  * yz/xz kernels take the upwind COLUMN at ix + sign_x (march direction)
    while the in-plane line buffer holds column ix - sign_x
    (characteristics.jl:424,463-464,477).
  * the line buffer starts at zero once and persists across the
    n_sweeps passes (characteristics.jl:399).
  * xz_down reads its "centre" alpha/S from the upper plane
    (characteristics.jl:794,804); yz_down from the current plane.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from . import march_cuda
from .formal import linear_weights, bezier_weights, bezier_control


# Columns per step of the plain march scan (lax.scan unroll): the best
# of U in {1, 4, 8, 16, 32} for a 256x256 plane at B = 16 and 364 on an
# NVIDIA H100 (analysis/bench_march.py, PERF.md).
_MARCH_UNROLL = 32


# --------------------------------------------------------------- planning

def xy_intersect(k):
    """Loop-direction signs from the k quadrant (functions.jl:430-457)."""
    if k[1] > 0 and k[2] > 0:
        return -1, -1
    if k[1] < 0 and k[2] > 0:
        return 1, -1
    if k[1] < 0 and k[2] < 0:
        return 1, 1
    if k[1] > 0 and k[2] < 0:
        return -1, 1
    return 1, 1


@dataclasses.dataclass(frozen=True)
class Segment:
    """A contiguous run of z-steps sharing one plane-cut case.

    All fields are hashable (tuples) so the whole plan can be a static
    jit argument -- the sweep schedule is compile-time constant.
    """
    case: str              # 'xy' | 'yz' | 'xz'
    steps: tuple           # z indices of the planes computed (march order)
    r: tuple               # path length per step [m]
    fx: tuple              # x stencil fraction per step (xy case)
    fy: tuple              # y stencil fraction per step (xy case)
    w_cur: tuple           # current-plane z-interp weight (yz/xz case)


@dataclasses.dataclass(frozen=True)
class RegularPlan:
    """Static sweep plan for one direction over one z grid."""
    k: tuple
    up: bool
    sign_x: int            # march/loop signs (xy_intersect)
    sign_y: int
    sxs: int               # stencil base shift in x: 0 if k_x>=0 else -1
    sys: int               # stencil base shift in y
    r_x: float             # dx/|k_x|
    r_y: float             # dy/|k_y|
    fy_line: float         # static y fraction for the yz case
    fx_line: float         # static x fraction for the xz case
    segments: tuple        # of Segment


def build_plan(k, z, dx, dy, up):
    """Compile the static sweep schedule for direction k (host side).

    Mirrors the per-z `plane_cut = argmin([r_z, r_x, r_y])` dispatch
    (characteristics.jl:71,160); for each z interval the winning case and
    all interpolation geometry depend only on (k, grid spacing), so they
    are precomputed here once.
    """
    k = np.asarray(k, dtype=np.float64)
    nz = len(z)
    sign_x, sign_y = xy_intersect(k)
    r_x = abs(dx / k[1]) if k[1] != 0 else np.inf
    r_y = abs(dy / k[2]) if k[2] != 0 else np.inf
    sxs = 0 if k[1] >= 0 else -1
    sys = 0 if k[2] >= 0 else -1

    # static in-line fractions for the marching cases
    if np.isfinite(r_x):
        uy = r_x * k[2]
        fy_line = float(np.clip(uy / dy - sys, 0.0, 1.0))
    else:
        fy_line = 1.0
    if np.isfinite(r_y):
        ux = r_y * k[1]
        fx_line = float(np.clip(ux / dx - sxs, 0.0, 1.0))
    else:
        fx_line = 1.0

    if up:
        steps = range(1, nz)
        dz_of = lambda i: z[i] - z[i - 1]
    else:
        steps = range(nz - 2, -1, -1)
        dz_of = lambda i: z[i + 1] - z[i]

    raw = []
    for i in steps:
        dz = dz_of(i)
        r_z = abs(dz / k[0]) if k[0] != 0 else np.inf
        case = ("xy", "yz", "xz")[int(np.argmin([r_z, r_x, r_y]))]
        if case == "xy":
            r = r_z
            fx = np.clip(r * k[1] / dx - sxs, 0.0, 1.0) if np.isfinite(r) else 1.0
            fy = np.clip(r * k[2] / dy - sys, 0.0, 1.0) if np.isfinite(r) else 1.0
            w_cur = 0.0
        elif case == "yz":
            r = r_x
            fx = fy = 0.0
            # z interp: up: between z[i-1] (w=1-t) and z[i] (w=t),
            #           t = 1 - r|k_z|/dz; down: between z[i] (w=1-t)
            #           and z[i+1] (w=t), t = r k_z/dz.  w_cur weights
            #           the CURRENT plane row in both.
            t = r * abs(k[0]) / dz
            w_cur = 1.0 - t
        else:
            r = r_y
            fx = fy = 0.0
            t = r * abs(k[0]) / dz
            w_cur = 1.0 - t
        raw.append((case, i, float(r), float(fx), float(fy), float(w_cur)))

    segments = []
    for (case, i, r, fx, fy, wc) in raw:
        if segments and segments[-1][0] == case:
            segments[-1][1].append((i, r, fx, fy, wc))
        else:
            segments.append([case, [(i, r, fx, fy, wc)]])
    segs = []
    for case, items in segments:
        segs.append(Segment(
            case=case,
            steps=tuple(i for (i, *_rest) in items),
            r=tuple(r for (_, r, _f, _g, _w) in items),
            fx=tuple(f for (_, _r, f, _g, _w) in items),
            fy=tuple(g for (_, _r, _f, g, _w) in items),
            w_cur=tuple(w for (_, _r, _f, _g, w) in items)))

    return RegularPlan(k=tuple(k), up=up, sign_x=sign_x, sign_y=sign_y,
                       sxs=sxs, sys=sys, r_x=float(r_x), r_y=float(r_y),
                       fy_line=fy_line, fx_line=fx_line,
                       segments=tuple(segs))


# --------------------------------------------------------------- kernels

def _shift(A, sx, sy):
    """A[..., x+sx, y+sy] with periodic wrap."""
    if sx:
        A = jnp.roll(A, -sx, axis=-2)
    if sy:
        A = jnp.roll(A, -sy, axis=-1)
    return A


def _stencil_xy(A, sxs, sys, fx, fy):
    """Bilinear sample at (x + fx', y + fy') -- separable lerp.

    Equals the reference's `bilinear` at the upwind point of the xy rays
    (characteristics.jl:247,257,266) on an equidistant periodic grid.
    Evaluated as lerp_x(lerp_y(A)): 2 rolls per array instead of the
    4-tap form's ~6 (one tap per axis is the identity shift).
    """
    Ay = (1.0 - fy) * _shift(A, 0, sys) + fy * _shift(A, 0, sys + 1)
    return (1.0 - fx) * _shift(Ay, sxs, 0) + fx * _shift(Ay, sxs + 1, 0)


def _xy_step(plan, carry_I, inputs):
    """One z-plane of the xy case: fully vectorized (B, Nx, Ny) update."""
    alpha_c, alpha_p, S_c, S_p, r, fx, fy, _wc = inputs
    a_up = _stencil_xy(alpha_p, plan.sxs, plan.sys, fx, fy)
    dtau = r * (alpha_c + a_up) * 0.5
    aw, bw, ew = linear_weights(dtau)
    S_up = _stencil_xy(S_p, plan.sxs, plan.sys, fx, fy)
    I_up = _stencil_xy(carry_I, plan.sxs, plan.sys, fx, fy)
    I_new = ew * I_up + aw * S_up + bw * S_c
    return I_new, I_new


def _xy_step_bezier(plan, carry_I, inputs):
    """xy plane update with quadratic-Bezier source integration.

    The control point needs the source/extinction one more interval
    upstream along the ray: the second-upwind point on plane z-2 is
    sampled by composing the previous step's stencil with this step's
    (bilinear-of-bilinear -- exact ray geometry, smoothed interpolation).
    """
    (alpha_c, alpha_p, S_c, S_p, alpha_pp, S_pp, r, fx, fy,
     r_prev, fx_prev, fy_prev, first) = inputs
    st = lambda A, f, g: _stencil_xy(A, plan.sxs, plan.sys, f, g)
    a_up = st(alpha_p, fx, fy)
    S_up = st(S_p, fx, fy)
    I_up = st(carry_I, fx, fy)
    a_uu = st(st(alpha_pp, fx_prev, fy_prev), fx, fy)
    S_uu = st(st(S_pp, fx_prev, fy_prev), fx, fy)
    dtau = r * (alpha_c + a_up) * 0.5
    dtau_uu = r_prev * (a_up + a_uu) * 0.5
    C = bezier_control(S_uu, S_up, S_c, dtau_uu, dtau, first)
    wu, wc, wk, ew = bezier_weights(dtau)
    I_new = ew * I_up + wu * S_up + wc * S_c + wk * C
    return I_new, I_new


def _roll_y(col, s):
    """col[..., y+s] periodic, col shaped (B, Ny)."""
    return jnp.roll(col, -s, axis=-1) if s else col


def _line_interp(col, sys, f):
    """(1-f) col[y+sys] + f col[y+sys+1] -- the orthogonal-axis interp."""
    return (1.0 - f) * _roll_y(col, sys) + f * _roll_y(col, sys + 1)


def _march_coefficients(r, f_line, s_base, w_cur, cols, centre_cols,
                        I_prev_cols):
    """Pass-invariant coefficients of the shared yz/xz marching kernel.

    cols: upwind-column slices (alpha_p, alpha_c, S_p, S_c) each
    (Nx, B, Ny) already gathered in march order at ix + sign; centre_cols:
    (alpha_c, S_c) at ix in march order; I_prev_cols: previous-plane
    intensity at ix + sign.

    Replicates characteristics.jl:420-483 (and the down/xz variants):
      upwind value = w_prev * [prev-plane col, y-interp]
                   + w_cur  * [line buffer, y-interp]
    with the line buffer carrying the previously computed line
    (reference's I_upper/I_lower), zero-initialised once and kept
    across the n_sweeps passes.

    Per column c the update is affine in the line buffer:

      i_new(c) = ew*(wp*LI(i_pw) ) + aw*s_up + bw*s_c0   [pass-invariant]
               + (ew*wc) * LI(buf)                       [per pass]

    so the invariant part (`const`, one exp evaluation) and the buffer
    coefficient (`coeff`) are computed ONCE as whole-plane vectorized
    ops, and each Gauss-Seidel pass (_march_lines) streams just those
    two arrays -- instead of re-reading seven plane arrays and
    re-evaluating linear_weights n_sweeps times.  Same math regrouped
    (distributive); equal to the oracle at the usual 1e-12.
    Returns (coeff, const), both (N, B, M) in march order.
    """
    alpha_pw, alpha_cw, S_pw, S_cw = cols
    alpha_c0, S_c0 = centre_cols
    r = jnp.asarray(r)          # scalar, or (B, 1) for batched angles
    f_line = jnp.asarray(f_line)
    # scalar, or (B, 1) for batched angles -- trailing-aligned broadcast
    # against the (N, B, M) plane arrays puts it per batch element,
    # constant over columns, exactly like the per-column old formulation
    wcb = jnp.asarray(w_cur)
    wp = 1.0 - wcb

    def LI(A):
        return _line_interp(A, s_base, f_line)

    # pass-invariant plane-wide precompute (single exp evaluation)
    a_up = wp * LI(alpha_pw) + wcb * LI(alpha_cw)
    dtau = r * (alpha_c0 + a_up) * 0.5
    aw, bw, ew = linear_weights(dtau)
    s_up = wp * LI(S_pw) + wcb * LI(S_cw)
    const = ew * (wp * LI(I_prev_cols)) + aw * s_up + bw * S_c0
    coeff = jnp.broadcast_to(ew * wcb, const.shape)
    return coeff, const


def _march_lines(coeff, const, f_line, s_base, n_sweeps):
    """The sequential part: the CUDA kernel of march_cuda.py where
    march_cuda.kernel_selected says so (a GPU, float32), the plain scan
    otherwise."""
    if march_cuda.kernel_selected(const.dtype):
        return march_cuda.march_lines(coeff, const, f_line, s_base,
                                      n_sweeps)
    return _march_scan(coeff, const, f_line, s_base, n_sweeps)


def _march_scan(coeff, const, f_line, s_base, n_sweeps,
                unroll=_MARCH_UNROLL):
    """The plain march recurrence: n_sweeps lax.scan passes over the
    columns, the (B, M) line buffer zero-initialised once and carried
    across passes.  Returns the last pass's lines (N, B, M)."""

    def line_body(buf, xs):
        coeff_c, const_c = xs
        i_new = coeff_c * _line_interp(buf, s_base, f_line) + const_c
        return i_new, i_new

    buf = jnp.zeros_like(const[0])
    lines = None
    for _ in range(n_sweeps):
        buf, lines = jax.lax.scan(line_body, buf, (coeff, const),
                                  unroll=unroll)
    return lines


def _gather_order(N, sign):
    """March order and upwind-column order (periodic) along an axis."""
    order = np.arange(N) if sign > 0 else np.arange(N - 1, -1, -1)
    upwind = (order + sign) % N
    inv = np.argsort(order)
    return order, upwind, inv


def _march_axis(plan, case):
    """(sign, line fraction, stencil shift, path length, march axis) of
    the yz ('x' march, lines (B, Ny)) or xz ('y' march, lines (B, Nx))
    case."""
    if case == "yz":
        return plan.sign_x, plan.fy_line, plan.sys, plan.r_x, -2
    return plan.sign_y, plan.fx_line, plan.sxs, plan.r_y, -1


def _march_plane_coefficients(plan, case, w_cur, carry_I, alpha_c,
                              alpha_p, S_c, S_p, centre_from_upper,
                              geom=None):
    """(coeff, const, f_line, s_base) of one z-plane of the yz/xz case:
    the inputs of _march_lines, in march order.

    geom: optional dict with traced per-batch-element overrides of the
    plan statics (f_line, r shaped (B, 1)) for angle-batched sweeps;
    may carry "c_prev" (B, 1, 1) selecting per element whether the
    centre alpha/S come from the upper plane (the xz-down quirk,
    characteristics.jl:794,804) -- exact for 0/1 weights, which lets
    originally-down angles batch with up angles after z-flip
    canonicalization (group_plans).
    """
    sign, f_line, s_base, r_m, ax = _march_axis(plan, case)
    if geom is not None:
        f_line = geom["f_line"]
        r_m = geom["r"]

    N = alpha_c.shape[ax]
    order, upwind, _ = _gather_order(N, sign)

    def take(A, idx):
        # (B, Nx, Ny) -> (N, B, M) with march axis leading
        M = jnp.take(A, idx, axis=ax)
        return jnp.moveaxis(M, ax, 0)

    if geom is not None and "c_prev" in geom:
        cp = geom["c_prev"]
        centre_a = cp * alpha_p + (1.0 - cp) * alpha_c
        centre_s = cp * S_p + (1.0 - cp) * S_c
    else:
        centre_a = alpha_p if centre_from_upper == "prev" else alpha_c
        centre_s = S_p if centre_from_upper == "prev" else S_c

    cols = (take(alpha_p, upwind), take(alpha_c, upwind),
            take(S_p, upwind), take(S_c, upwind))
    centre_cols = (take(centre_a, order), take(centre_s, order))
    I_prev_cols = take(carry_I, upwind)
    coeff, const = _march_coefficients(r_m, f_line, s_base, w_cur, cols,
                                       centre_cols, I_prev_cols)
    return coeff, const, f_line, s_base


def _march_plane(plan, case, n_sweeps, w_cur, carry_I, alpha_c, alpha_p,
                 S_c, S_p, centre_from_upper, geom=None):
    """One z-plane of the yz ('x' march) or xz ('y' march) case (geom:
    see _march_plane_coefficients)."""
    coeff, const, f_line, s_base = _march_plane_coefficients(
        plan, case, w_cur, carry_I, alpha_c, alpha_p, S_c, S_p,
        centre_from_upper, geom)
    lines = _march_lines(coeff, const, f_line, s_base, n_sweeps)
    # un-permute march order and put the axis back
    sign, _, _, _, ax = _march_axis(plan, case)
    _, _, inv = _gather_order(const.shape[0], sign)
    lines = jnp.take(lines, inv, axis=0)
    return jnp.moveaxis(lines, 0, ax)


# ----------------------------------------------------------------- sweep

@partial(jax.jit, static_argnames=("plan", "n_sweeps", "interpolation"))
def sweep(plan: RegularPlan, S, alpha, I0, z_unused=None, n_sweeps=3,
          interpolation="linear"):
    """Formal solution along direction plan.k over the whole grid.

    Args:
      plan: RegularPlan from build_plan (static).
      S, alpha: (nz, B, Nx, Ny) source function / extinction.
      I0: (B, Nx, Ny) boundary intensity (bottom plane for up sweeps,
          top plane for down sweeps; lambda_iteration.jl:38-52).
      n_sweeps: Gauss-Seidel passes for the marching cases.
      interpolation: 'linear' (reference parity, functions.jl:484-500)
        or 'bezier' (quadratic DELO-Bezier source integration in the xy
        segments; marching segments stay linear -- their one-line buffer
        has no second-upwind sample).
    Returns:
      I: (nz, B, Nx, Ny).

    Equivalent of short_characteristics_up/_down (characteristics.jl:19,110).
    """
    nz = S.shape[0]
    planes = {}          # z index -> computed plane
    carry = I0
    bc_index = 0 if plan.up else nz - 1
    planes[bc_index] = I0

    for seg in plan.segments:
        idx = np.asarray(seg.steps)
        prev = idx - 1 if plan.up else idx + 1
        alpha_c = alpha[idx]
        alpha_p = alpha[prev]
        S_c = S[idx]
        S_p = S[prev]
        if seg.case == "xy" and interpolation == "bezier":
            # second-upwind plane (two z-steps back; clamped at the
            # boundary and at the segment start, where the previous
            # step's ray geometry duplicates this step's)
            prev2 = np.clip(idx - 2 if plan.up else idx + 2, 0,
                            nz - 1)
            r_prev = np.concatenate([seg.r[:1], seg.r[:-1]])
            fx_prev = np.concatenate([seg.fx[:1], seg.fx[:-1]])
            fy_prev = np.concatenate([seg.fy[:1], seg.fy[:-1]])
            # no upstream sample at the boundary plane or a segment
            # start: flag -> secant slope (linear-equivalent interval)
            first = np.zeros(len(seg.steps))
            first[0] = 1.0
            xs = (alpha_c, alpha_p, S_c, S_p, alpha[prev2], S[prev2],
                  jnp.asarray(seg.r), jnp.asarray(seg.fx),
                  jnp.asarray(seg.fy), jnp.asarray(r_prev),
                  jnp.asarray(fx_prev), jnp.asarray(fy_prev),
                  jnp.asarray(first))
            carry, ys = jax.lax.scan(partial(_xy_step_bezier, plan),
                                     carry, xs)
        elif seg.case == "xy":
            xs = (alpha_c, alpha_p, S_c, S_p,
                  jnp.asarray(seg.r), jnp.asarray(seg.fx),
                  jnp.asarray(seg.fy), jnp.asarray(seg.w_cur))
            carry, ys = jax.lax.scan(partial(_xy_step, plan), carry, xs)
        else:
            centre = "prev" if (seg.case == "xz" and not plan.up) else "cur"

            def plane_body(carry_I, xs, case=seg.case, centre=centre):
                a_c, a_p, s_c, s_p, wc = xs
                I_new = _march_plane(plan, case, n_sweeps, wc, carry_I,
                                     a_c, a_p, s_c, s_p, centre)
                return I_new, I_new

            xs = (alpha_c, alpha_p, S_c, S_p, jnp.asarray(seg.w_cur))
            carry, ys = jax.lax.scan(plane_body, carry, xs)
        for j, i in enumerate(seg.steps):
            planes[i] = ys[j]

    return jnp.stack([planes[i] for i in range(nz)], axis=0)


# ----------------------------------------------------- angle batching

def plan_signature(plan: RegularPlan):
    """Structural identity of a plan: two plans with equal signatures
    compile to the same program and can share one batched sweep."""
    return (plan.up, plan.sign_x, plan.sign_y, plan.sxs, plan.sys,
            tuple((s.case, s.steps) for s in plan.segments))


def canonical_flips(k):
    """Axis flips taking direction k to the canonical quadrant.

    Flipping the x (or y) axis of all fields maps a sweep along
    (k0, k1, k2) to one along (k0, -k1, k2): mirror-pair quadrature
    angles land on identical plan signatures and batch into one sweep.
    """
    return bool(k[1] < 0), bool(k[2] < 0)


def flip_field(A, flip_x, flip_y, flip_z=False):
    """Reverse the trailing (x, y) axes; exact (periodic domain).

    flip_z reverses the LEADING axis -- only meaningful for z-leading
    field arrays (nz, ...), not boundary planes.
    """
    if flip_z:
        A = jnp.flip(A, axis=0)
    if flip_x:
        A = jnp.flip(A, axis=-2)
    if flip_y:
        A = jnp.flip(A, axis=-1)
    return A


def group_plans(ks, ups, z, dx, dy, max_group=None):
    """Bucket quadrature directions by canonical plan signature.

    Returns a list of groups; each group is a list of
    (angle_index, canonical_plan, (flip_x, flip_y, flip_z)).  Marching
    (yz/xz) sweeps are latency-bound, so batching a group's angles
    into the wavelength axis runs them for ~the cost of one.

    max_group caps the angles per group: a batched group holds P
    per-angle extinction fields plus their stacked copy as execution
    temporaries, so at production grids with wide lambda chunks the
    4-angle ul7n12 groups exceed device memory next to the resident
    (nlam, nz, nx, ny) fields -- cap P so P * chunk-field bytes fits
    the headroom (the caller knows the chunk size).

    Down sweeps are z-flip-canonicalized into up sweeps: reversing the
    z axis of the fields (and the dz sequence of the plan) maps a
    down march exactly onto an up march -- plane t's upwind plane
    t - dir becomes t + dir under the index reversal, every per-step
    update is the same arithmetic, and the one direction-asymmetric
    quirk (xz_down reads centre alpha/S from the upper plane,
    characteristics.jl:794,804) is preserved per element through
    sweep_batched's down_flags.  This halves the number of compiled
    sweeps for symmetric quadratures (ul7n12: 6 groups -> 3).
    """
    z = np.asarray(z)
    # z-flipped axis: ascending, with the dz sequence reversed
    zf = z[0] + (z[-1] - z[::-1])
    groups = {}
    for i, (k, up) in enumerate(zip(ks, ups)):
        fx, fy = canonical_flips(k)
        fz = not bool(up)
        kc = np.array([-abs(k[0]), abs(k[1]), abs(k[2])])
        plan = build_plan(kc, zf if fz else z, dx, dy, True)
        sig = plan_signature(plan)
        groups.setdefault(sig, []).append((i, plan, (fx, fy, fz)))
    out = list(groups.values())
    if max_group is not None and max_group >= 1:
        out = [g[j:j + max_group] for g in out
               for j in range(0, len(g), max_group)]
    return out


def _geom_stack(vals_per_plan, B_lam, extra_dims):
    """(P lists of per-step tuples) -> (L, P*B_lam, *1s) traced array."""
    a = np.stack([np.asarray(v) for v in vals_per_plan], axis=1)  # (L, P)
    a = np.repeat(a, B_lam, axis=1)
    return jnp.asarray(a.reshape(a.shape + (1,) * extra_dims))


def _sweep_batched_impl(plans, S, alpha, I0, n_sweeps, down_flags, emit):
    """Shared body of sweep_batched / sweep_batched_J.

    Runs the batched multi-angle sweep and calls emit(plane) on every
    computed (P*B, Nx, Ny) intensity plane (and on the BC plane);
    returns the emitted pytrees stacked along a leading z axis.
    """
    lead = plans[0]
    P = len(plans)
    nz = S.shape[0]
    B_lam = S.shape[1] // P
    if down_flags is None:
        down_flags = tuple(not p.up for p in plans)
    planes = {}
    carry = I0
    bc_index = 0 if lead.up else nz - 1
    planes[bc_index] = emit(I0)
    dirn = 1 if lead.up else -1

    def plane(A, t):
        return jax.lax.dynamic_index_in_dim(A, t, axis=0, keepdims=False)

    for si, seg in enumerate(lead.segments):
        # planes are indexed on the fly inside the scan (slicing the
        # stacked (L, P*B, Nx, Ny) copies up front doubles the
        # fields' device memory at production sizes)
        steps_t = jnp.asarray(np.asarray(seg.steps, dtype=np.int32))
        segs_p = [p.segments[si] for p in plans]
        if seg.case == "xy":
            xs = (steps_t,
                  _geom_stack([s.r for s in segs_p], B_lam, 2),
                  _geom_stack([s.fx for s in segs_p], B_lam, 2),
                  _geom_stack([s.fy for s in segs_p], B_lam, 2))

            def xy_body(carry_I, xs_t):
                t, r, fx, fy = xs_t
                step = (plane(alpha, t), plane(alpha, t - dirn),
                        plane(S, t), plane(S, t - dirn), r, fx, fy, 0.0)
                I_new, _ = _xy_step(lead, carry_I, step)
                return I_new, emit(I_new)

            carry, ys = jax.lax.scan(xy_body, carry, xs)
        else:
            if seg.case == "yz":
                f_vals = [p.fy_line for p in plans]
                r_vals = [p.r_x for p in plans]
            else:
                f_vals = [p.fx_line for p in plans]
                r_vals = [p.r_y for p in plans]
            geom = {
                "f_line": jnp.asarray(
                    np.repeat(np.asarray(f_vals), B_lam)[:, None]),
                "r": jnp.asarray(
                    np.repeat(np.asarray(r_vals), B_lam)[:, None]),
            }
            # the xz centre quirk: originally-down angles read centre
            # alpha/S from the upper plane = the prev plane in
            # canonical (z-flipped) coordinates
            if seg.case == "xz" and any(down_flags):
                if all(down_flags):
                    centre = "prev"
                else:
                    centre = "cur"
                    cp = np.repeat(
                        np.asarray(down_flags, dtype=np.float64), B_lam)
                    geom["c_prev"] = jnp.asarray(cp[:, None, None],
                                                 dtype=S.dtype)
            else:
                centre = "cur"

            def plane_body(carry_I, xs_t, case=seg.case, centre=centre,
                           geom=geom):
                t, wc = xs_t
                I_new = _march_plane(lead, case, n_sweeps, wc, carry_I,
                                     plane(alpha, t),
                                     plane(alpha, t - dirn),
                                     plane(S, t), plane(S, t - dirn),
                                     centre, geom=geom)
                return I_new, emit(I_new)

            xs = (steps_t,
                  _geom_stack([s.w_cur for s in segs_p], B_lam, 1))
            carry, ys = jax.lax.scan(plane_body, carry, xs)
        for j, i in enumerate(seg.steps):
            planes[i] = jax.tree.map(lambda a, j=j: a[j], ys)

    ordered = [planes[i] for i in range(nz)]
    return jax.tree.map(lambda *xs: jnp.stack(xs, axis=0), *ordered)


@partial(jax.jit, static_argnames=("plans", "n_sweeps", "down_flags"))
def sweep_batched(plans, S, alpha, I0, n_sweeps=3, down_flags=None):
    """One sweep for several same-signature directions at once.

    Args:
      plans: tuple of P canonical RegularPlans with equal
        plan_signature (from group_plans).
      S, alpha: (nz, P*B, Nx, Ny) -- the per-angle (already
        canonically flipped, z-flipped for originally-down angles)
        fields stacked along the batch axis.
      I0: (P*B, Nx, Ny) stacked boundary intensities.
      down_flags: tuple of P bools -- which plans were originally DOWN
        sweeps before z-flip canonicalization (group_plans' flip_z).
        Only the xz case is direction-asymmetric (centre alpha/S from
        the upper plane, characteristics.jl:794,804); a 0/1 per-element
        blend keeps mixed groups exact.
    Returns:
      I: (nz, P*B, Nx, Ny); split axis 1 into P blocks and unflip to
      recover the per-angle results.  Linear interpolation only.

    The per-direction geometry (path lengths, stencil fractions,
    current-plane weights, line fractions) becomes traced per-element
    arrays; the compiled program is the single-angle one with a wider
    batch, so the latency-bound marching segments amortize P ways.
    """
    return _sweep_batched_impl(plans, S, alpha, I0, n_sweeps, down_flags,
                               lambda p: p)


@partial(jax.jit,
         static_argnames=("plans", "n_sweeps", "down_flags", "unflips"),
         donate_argnums=(1, 2))
def sweep_batched_J(plans, S, alpha, I0, w, n_sweeps=3, down_flags=None,
                    unflips=None):
    """Batched multi-angle sweep emitting the weighted J contribution.

    Identical numerics to sweep_batched, but instead of materializing
    the full (nz, P*B, Nx, Ny) intensity cube it reduces every computed
    plane over the P angle blocks on the fly:

        part[e] = w[e] * unflip_xy(I_plane[e*B:(e+1)*B])

    summed separately over originally-up and originally-down angles.
    This cuts the sweep's device-memory high-water mark by ~(P-1)/P of
    the output cube (at P = 4 angles, 192x64x256^2 f32, the full cube
    is 3.2 GB), and the donated S/alpha stacks let XLA reuse their
    buffers.

    Args:
      w: (P,) quadrature weights.
      unflips: tuple of P (flip_x, flip_y) pairs undoing the canonical
        quadrant flip of each block before accumulation.
    Returns:
      (J_up, J_dn): each (nz, B, Nx, Ny) in CANONICAL z order; the
      caller adds J_up + flip_z(J_dn) into J (originally-down angles
      were z-flipped, so their canonical plane t is physical plane
      nz-1-t).
    """
    P = len(plans)
    B_lam = S.shape[1] // P
    if unflips is None:
        unflips = tuple((False, False) for _ in plans)
    if down_flags is None:
        down_flags = tuple(not p.up for p in plans)

    def emit(I_plane):
        up_acc = None
        dn_acc = None
        for e in range(P):
            blk = w[e] * flip_field(I_plane[e * B_lam:(e + 1) * B_lam],
                                    *unflips[e])
            if down_flags[e]:
                dn_acc = blk if dn_acc is None else dn_acc + blk
            else:
                up_acc = blk if up_acc is None else up_acc + blk
        zero = jnp.zeros_like(I_plane[:B_lam])
        return (up_acc if up_acc is not None else zero,
                dn_acc if dn_acc is not None else zero)

    return _sweep_batched_impl(plans, S, alpha, I0, n_sweeps, down_flags,
                               emit)


@partial(jax.jit,
         static_argnames=("plans", "n_sweeps", "flips"))
def sweep_group_J(plans, S, a_list, I0_list, w, n_sweeps=3, flips=None):
    """One angle group's weighted J contribution from RAW fields.

    Performs the canonical flip + batch-stack + batched sweep + reduced
    emission entirely inside one jit: the (nz, P*B, Nx, Ny) stacks and
    every intermediate are XLA-managed temporaries allocated at
    EXECUTION time, so eagerly dispatching several groups back-to-back
    never holds more than one group's working set plus the persistent
    fields (the eager stack-then-call formulation allocates all groups'
    stacks at enqueue time under async dispatch).

    Args:
      S: shared source function (nz, B, Nx, Ny).
      a_list: tuple of P per-angle extinctions, same shape as S.
      I0_list: tuple of P per-angle boundary planes (B, Nx, Ny).
      w: (P,) quadrature weights.
      flips: tuple of P (flip_x, flip_y, flip_z) from group_plans.
    Returns:
      The group's J contribution (nz, B, Nx, Ny), physical orientation.
    """
    if flips is None:
        flips = tuple((False, False, False) for _ in plans)
    down_flags = tuple(f[2] for f in flips)
    S_b = jnp.concatenate([flip_field(S, *f) for f in flips], axis=1)
    a_b = jnp.concatenate([flip_field(a, *f)
                           for a, f in zip(a_list, flips)], axis=1)
    I0_b = jnp.concatenate([flip_field(i0, f[0], f[1])
                            for i0, f in zip(I0_list, flips)], axis=0)
    J_up, J_dn = sweep_batched_J(plans, S_b, a_b, I0_b, w,
                                 n_sweeps=n_sweeps,
                                 down_flags=down_flags,
                                 unflips=tuple((f[0], f[1])
                                               for f in flips))
    return J_up + jnp.flip(J_dn, axis=0)


# ------------------------------------------------------------ public API

def short_characteristics(k, S, alpha, I0, z, dx, dy, up, n_sweeps=3,
                          plan=None, interpolation="linear"):
    """Convenience wrapper building (or reusing) the static plan.

    S/alpha may be (nz, Nx, Ny) or (nz, B, Nx, Ny); I0 (Nx, Ny) or
    (B, Nx, Ny).  Returns intensity with matching shape.
    """
    squeeze = S.ndim == 3
    if squeeze:
        S = S[:, None]
        alpha = alpha[:, None]
        I0 = I0[None]
    if plan is None:
        plan = build_plan(k, np.asarray(z), dx, dy, up)
    I = sweep(plan, S, alpha, I0, n_sweeps=n_sweeps,
              interpolation=interpolation)
    return I[:, 0] if squeeze else I
