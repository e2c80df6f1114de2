"""Radiative (R) and collisional (C) rate matrices for the 3-level atom.

Reference parity: src/rates.jl.  Level/rate indexing is 0-based here:
R[i][j] = rate level i -> level j, i,j in {0,1,2} with 2 = continuum.
Rates are returned as a nested structure P[i][j] of per-cell arrays.

Compat quirks reproduced when cfg.compat == 'reference'
(SURVEY.md §7 "fidelity traps"):
  * Rij integrals carry (f_l + f_{l+1}) * dlam / 1000 -- i.e. 2x the
    trapezoid times 1e-3 (rates.jl:221,236,259,274); Rji carries
    (f_l + f_{l+1}) * dlam (2x trapezoid, no /1000).
  * sigma_ic uses lam[end] as the edge wavelength and n_eff from
    chi_j - chi_i for BOTH levels (rates.jl:427-431).
  * collisional rates are multiplied by BOOST (rates.jl:3,522,550).
With compat == 'fixed', proper 0.5x trapezoids and per-level n_eff
are used instead.
"""

import jax.numpy as jnp
import numpy as np

from ..constants import h, c_0, e, eps_0, m_e, hc, R_inf, E_inf, IUNIT_SI
from .voigt import voigt_profile
from .broadening import damping
from .collisions import coll_exc_hydrogen_johnson, coll_ion_hydrogen_johnson


def gaunt_bf(lam, charge, n_eff):
    """Bound-free Gaunt factor, Seaton (1960) (src/rates.jl:562-572)."""
    x = 1.0 / (lam * R_inf * charge**2)
    x3 = x ** (1.0 / 3.0)
    nsqx = 1.0 / (n_eff**2 * x)
    return (1.0 + 0.1728 * x3 * (1.0 - 2.0 * nsqx)
            - 0.0496 * x3**2 * (1.0 - (1.0 - nsqx) * 0.66666667 * nsqx))


def sigma_ij_bb(line, lam, damping_lam):
    """Bound-bound cross-section [m^2] per (lam, cell) (rates.jl:374-413).

    sigma = h c/(4 pi lam0) * Bij * phi(lam);  note: NO Doppler shift here
    (the reference evaluates v without v_los for the rate integral).
    """
    sigma_const = hc / (4.0 * np.pi * line.lam0) * line.Bij
    lam_b = jnp.asarray(lam).reshape((-1,) + (1,) * line.dlamD.ndim)
    v = (lam_b - line.lam0) / line.dlamD[None]
    profile = voigt_profile(damping_lam, v, line.dlamD[None])
    return sigma_const * profile


def sigma_ic(level, line, lam, compat="reference"):
    """Bound-free cross-section [m^2] per lam (rates.jl:422-438).

    level: 0 (lower) or 1 (upper), 0-based.
    """
    lam = jnp.asarray(lam)
    if compat == "reference":
        lam_edge = lam[-1]
        neff = np.sqrt(E_inf / (line.chi_j - line.chi_i))
    else:
        chi_level = line.chi_i if level == 0 else line.chi_j
        lam_edge = hc / (line.chi_inf - chi_level)
        neff = line.Z * np.sqrt(E_inf / (line.chi_inf - chi_level))
    lam3_ratio = (lam / lam_edge) ** 3
    charge = line.Z
    sigma_const = 4.0 * e**2 / (3.0 * np.pi * np.sqrt(3.0) * eps_0
                                * m_e * c_0**2 * R_inf)
    return (sigma_const * charge**4 * neff * lam3_ratio
            * gaunt_bf(lam, charge, neff))


def Gij(i, j, lam, temperature, lte_pops):
    """LTE/stimulated factor (rates.jl:449-484); i, j 0-based levels.

    G = (n_i/n_j)_LTE * exp(-h c / (lam k_B T)).
    """
    from ..constants import k_B
    lam_b = jnp.asarray(lam).reshape((-1,) + (1,) * temperature.ndim)
    n_ratio = lte_pops[..., i] / lte_pops[..., j]
    T_b = jnp.asarray(temperature)[None]
    # (hc/k_B)/(lam T) grouping keeps float32 intermediates in range
    return n_ratio[None] * jnp.exp(-(hc / k_B) / (lam_b * T_b))


def _pair_sum(f, lam, compat):
    """Sum over wavelength pairs: (f_l + f_{l+1}) * dlam [* 0.5 if fixed].

    f has lam on axis 0; reference applies NO 0.5 factor (rates.jl:219-221).
    """
    dlam = jnp.diff(jnp.asarray(lam))
    shape = (-1,) + (1,) * (f.ndim - 1)
    contrib = (f[:-1] + f[1:]) * dlam.reshape(shape)
    out = jnp.sum(contrib, axis=0)
    if compat == "fixed":
        out = 0.5 * out
    return out


def Rij_integral(J, sigma, lam, compat="reference"):
    """Excitation/ionization radiative rate [s^-1] (rates.jl:204-278).

    R = 2 pi/(h c) * sum_l (lam sigma J)_pairs * dlam [/1000 in reference].
    J in IUNIT; converted to SI inside.
    """
    lam_b = jnp.asarray(lam).reshape((-1,) + (1,) * (J.ndim - 1))
    f = lam_b * sigma * (J * IUNIT_SI)
    R = 2.0 * np.pi / hc * _pair_sum(f, lam, compat)
    if compat == "reference":
        R = R / 1000.0
    return R


def Rji_integral(J, sigma, G, lam, compat="reference"):
    """De-excitation/recombination radiative rate [s^-1] (rates.jl:280-364).

    R = 2 pi/(h c) * sum (sigma G lam (2 h c^2/lam^5 + J))_pairs * dlam.
    (No /1000 in the reference -- the asymmetry is intentional parity.)

    Float32 safety: lam**5 ~ 6e-39 at the upper-level bf edge (22.8 nm)
    is denormal -- flushed to zero it makes the Planck term inf
    (inf * G=0 -> NaN).  Evaluated in IUNIT with a log-space
    prefactor instead; mathematically identical.
    """
    lam_b = jnp.asarray(lam).reshape((-1,) + (1,) * (J.ndim - 1))
    planck_iunit = jnp.exp(
        float(np.log(2.0 * h * c_0**2 / IUNIT_SI)) - 5.0 * jnp.log(lam_b))
    f = (sigma * lam_b * IUNIT_SI) * G * (planck_iunit + J)
    return 2.0 * np.pi / hc * _pair_sum(f, lam, compat)


def calculate_R(line, J_lam, damping_lam, lte_pops, temperature,
                compat="reference"):
    """Full radiative-rate structure (rates.jl:96-201).

    J_lam: (nlam, ...) in IUNIT, damping_lam: (nlam, ...).
    Returns dict {(i, j): array} with 0-based levels, diagonal absent.
    """
    i0, i1, i2, i3 = line.lam_idx
    R = {}
    # ionization from each bound level
    for level, (start, stop) in enumerate(((i1, i2), (i2, i3))):
        lam_w = line.lam[start:stop]
        sig = sigma_ic(level, line, lam_w, compat)
        sig_b = sig.reshape((-1,) + (1,) * (J_lam.ndim - 1))
        G = Gij(level, 2, lam_w, temperature, lte_pops)
        R[(level, 2)] = Rij_integral(J_lam[start:stop], sig_b, lam_w, compat)
        R[(2, level)] = Rji_integral(J_lam[start:stop], sig_b, G, lam_w,
                                     compat)
    # bound-bound
    lam_w = line.lam[i0:i1]
    sig = sigma_ij_bb(line, lam_w, damping_lam[i0:i1])
    G = Gij(0, 1, lam_w, temperature, lte_pops)
    R[(0, 1)] = Rij_integral(J_lam[i0:i1], sig, lam_w, compat)
    R[(1, 0)] = Rji_integral(J_lam[i0:i1], sig, G, lam_w, compat)
    return R


def _window_pairs(line):
    """Per-window global pair ranges [p0, p1): pair p integrates rows
    (p, p+1), both inside the window (the reference's pair sums never
    straddle the bb/bf window boundaries -- rates.jl slices each
    window before summing)."""
    i0, i1, i2, i3 = line.lam_idx
    return (((i1, i2 - 1), "bf0"), ((i2, i3 - 1), "bf1"),
            ((i0, i1 - 1), "bb"))


def calculate_R_chunk(line, acc, J_blk, r0, g_cell, lte_pops,
                      temperature, compat="reference"):
    """Accumulate one lambda-block's contribution to the radiative-rate
    integrals (streaming form of calculate_R: full J never needs to be
    resident -- the production regular grid's (91, 215, 256, 256) J is
    5.13 GB).

    J_blk: (nb, ...) J rows covering GLOBAL lambda rows [r0, r0+nb)
      (pass the previous chunk's last row as row 0 so boundary pairs
      are integrated exactly once; r0 = chunk_start - 1 then).
    acc: dict {(i, j): array} running partials, or None to start.
    g_cell: per-cell damping gamma (bb sigma recomputed in-block).
    r0 and the block length are static per chunk shape -- the window
    intersections resolve at trace time.

    Sum over chunks == calculate_R up to float addition order (pinned
    by tests/test_rates_stream.py).
    """
    nb = int(J_blk.shape[0])
    lam_all = np.asarray(line.lam)
    out = dict(acc) if acc is not None else {}

    def add(key, val):
        out[key] = val if key not in out else out[key] + val

    for (p0, p1), kind in _window_pairs(line):
        a = max(p0, r0)
        b = min(p1, r0 + nb - 1)
        if a >= b:
            continue
        rows = slice(a - r0, b - r0 + 1)       # J rows a..b inclusive
        lam_w = lam_all[a:b + 1]
        J_w = J_blk[rows]
        if kind == "bb":
            lam_b = jnp.asarray(lam_w).reshape(
                (-1,) + (1,) * g_cell.ndim)
            damp = damping(g_cell[None], lam_b, line.dlamD[None])
            sig = sigma_ij_bb(line, lam_w, damp)
            G = Gij(0, 1, lam_w, temperature, lte_pops)
            add((0, 1), Rij_integral(J_w, sig, lam_w, compat))
            add((1, 0), Rji_integral(J_w, sig, G, lam_w, compat))
        else:
            level = 0 if kind == "bf0" else 1
            # compat sigma_ic uses lam[end] of the WINDOW as the edge
            we = p1 + 1
            sig = _sigma_ic_rows(level, line, lam_w, lam_all[we - 1],
                                 compat)
            sig_b = sig.reshape((-1,) + (1,) * (J_w.ndim - 1))
            G = Gij(level, 2, lam_w, temperature, lte_pops)
            add((level, 2), Rij_integral(J_w, sig_b, lam_w, compat))
            add((2, level), Rji_integral(J_w, sig_b, G, lam_w, compat))
    return out


def _sigma_ic_rows(level, line, lam_w, lam_edge_ref, compat):
    """sigma_ic over an arbitrary row subset of a bf window: the
    reference variant's edge wavelength is the WINDOW's last lambda
    (rates.jl:427-431), which a chunk may not contain -- pass it in."""
    lam = jnp.asarray(lam_w)
    if compat == "reference":
        lam_edge = lam_edge_ref
        neff = np.sqrt(E_inf / (line.chi_j - line.chi_i))
    else:
        chi_level = line.chi_i if level == 0 else line.chi_j
        lam_edge = hc / (line.chi_inf - chi_level)
        neff = line.Z * np.sqrt(E_inf / (line.chi_inf - chi_level))
    lam3_ratio = (lam / lam_edge) ** 3
    charge = line.Z
    sigma_const = 4.0 * e**2 / (3.0 * np.pi * np.sqrt(3.0) * eps_0
                                * m_e * c_0**2 * R_inf)
    return (sigma_const * charge**4 * neff * lam3_ratio
            * gaunt_bf(lam, charge, neff))


def Cij(i, j, electron_density, temperature, lte_pops, boost=2.0e9):
    """Collisional rate i -> j [s^-1], 0-based levels (rates.jl:496-551)."""
    ionized = 2  # 0-based index of the continuum "level"
    if i < j:
        if j < ionized:
            C = coll_exc_hydrogen_johnson(i + 1, j + 1, electron_density,
                                          temperature)
        else:
            C = coll_ion_hydrogen_johnson(i + 1, electron_density,
                                          temperature)
    else:
        if i < ionized:
            C = coll_exc_hydrogen_johnson(j + 1, i + 1, electron_density,
                                          temperature)
        else:
            C = coll_ion_hydrogen_johnson(j + 1, electron_density,
                                          temperature)
        C = C * lte_pops[..., j] / lte_pops[..., i]
    return C * boost


def calculate_C(electron_density, temperature, lte_pops, boost=2.0e9):
    """Full collisional-rate structure (rates.jl:11-85)."""
    C = {}
    for level in (0, 1):
        C[(level, 2)] = Cij(level, 2, electron_density, temperature,
                            lte_pops, boost)
        C[(2, level)] = Cij(2, level, electron_density, temperature,
                            lte_pops, boost)
    C[(0, 1)] = Cij(0, 1, electron_density, temperature, lte_pops, boost)
    C[(1, 0)] = Cij(1, 0, electron_density, temperature, lte_pops, boost)
    return C
