"""Continuum opacity recipes.

Reference parity: src/radiation.jl:28-56 (`α_absorption`, `α_scattering`),
which delegates to Transparency.jl.  This module re-implements every term
from the published literature:

  hminus_ff     H- free-free: Bell & Berrington (1987) fit as given by
                Gray (2005, 3rd ed., eq. 8.13).  The reference uses the
                Stilley & Callaway (1970) table; the two agree to a few
                percent over the overlap region (see docs/PARITY.md).
  hminus_bf     H- bound-free: Wishart (1979) cross-section polynomial
                (Gray 2005 eq. 8.11) x LTE H- Saha population with
                stimulated emission.  Reference recipe: Geltman (1962)
                table; few-percent agreement.
  hydrogenic_ff Kramers free-free with Gaunt factor (Gray 2005 eq. 8.6).
  h2plus_bf/ff  H2+ quasi-molecular opacity; documented approximation to
                Bates (1952) -- see docs/PARITY.md.  For charge-consistent
                states (n_p ~ n_e) it contributes <~2% of the 500 nm
                continuum; bounded by tests/test_physics.py TestH2PlusBudget.
  thomson       Thomson scattering off free electrons.
  rayleigh_h    Rayleigh scattering off H I (Dalgarno-style lambda^-4
                expansion; zero below the 121.77 nm resonance edge, the
                same cutoff behaviour noted at src/radiation.jl:54).

All inputs SI (m, K, m^-3); outputs are extinction in m^-1.
"""

import jax.numpy as jnp
import numpy as np

from ..constants import h, c_0, k_B, m_e, sigma_T

# ---------------------------------------------------------------- Thomson


def thomson(n_e):
    """Thomson scattering extinction [m^-1]."""
    return sigma_T * n_e


# -------------------------------------------------------------- Rayleigh

_RAYLEIGH_EDGE = 121.77e-9  # m; redward-of-Lyman-alpha validity edge


def rayleigh_h(lam, n_h1):
    """Rayleigh scattering off neutral hydrogen [m^-1].

    sigma(lambda) = 5.799e-13/l^4 + 1.422e-6/l^6 + 2.784/l^8  [cm^2],
    l = lambda in Angstrom (Dalgarno, as used in RH rayleigh.c).  Returns 0
    below the 121.77 nm edge (reference comment src/radiation.jl:54).
    """
    lA = lam * 1e10
    sigma_cm2 = 5.799e-13 / lA**4 + 1.422e-6 / lA**6 + 2.784 / lA**8
    sigma = sigma_cm2 * 1e-4  # -> m^2
    return jnp.where(lam > _RAYLEIGH_EDGE, sigma * n_h1, 0.0)


# ------------------------------------------------------------ H- free-free

# Gray (2005) eq. 8.13 coefficients (Bell & Berrington 1987 fit).
_BB_F0 = (-2.2763, -1.6850, 0.76661, -0.053346)
_BB_F1 = (15.2827, -9.2846, 1.99381, -0.142631)
_BB_F2 = (-197.789, 190.266, -67.9775, 10.6913, -0.625151)


def _poly_log(loglam, coefs):
    out = 0.0
    for i, c in enumerate(coefs):
        out = out + c * loglam**i
    return out


def hminus_ff(lam, T, n_h1, n_e):
    """H- free-free extinction [m^-1].

    Bell & Berrington (1987) fit: alpha = 1e-26 * p_e * 10^f per neutral
    H atom (cgs), p_e electron pressure [dyn cm^-2].  Valid for
    lambda > 2600 A; lambda is clamped below that (the term is negligible
    against Rayleigh + line opacity in the far UV).
    """
    lA = jnp.clip(lam * 1e10, 2600.0, 113900.0)
    loglam = jnp.log10(lA)
    logth = jnp.log10(5040.0 / T)
    f = (_poly_log(loglam, _BB_F0)
         + _poly_log(loglam, _BB_F1) * logth
         + _poly_log(loglam, _BB_F2) * logth**2)
    # cgs electron pressure; multiplication ordered so every float32
    # intermediate stays in range (1e-26 * 1e2 cm->m folded first)
    p_e = (n_e * 1e-6) * 1.380649e-16 * T
    return (1e-24 * p_e) * 10.0**f * (n_h1 * 1e-6)


# ----------------------------------------------------------- H- bound-free

# Wishart (1979) cross-section fit, Gray (2005) eq. 8.11; lambda in Angstrom,
# sigma in 1e-18 cm^2.  Photodetachment edge at 16444 A (0.7542 eV).
_WISHART = (1.99654, -1.18267e-5, 2.64243e-6, -4.40524e-10,
            3.23992e-14, -1.39568e-18, 2.78701e-23)
_CHI_HMINUS = 0.754195 * 1.602176634e-19   # H- binding energy [J]


def hminus_bf_sigma(lam):
    """H- photodetachment cross-section [m^2] (Wishart 1979 fit)."""
    lA = lam * 1e10
    s = 0.0
    for i, a in enumerate(_WISHART):
        s = s + a * lA**i
    s = jnp.where((lA < 16444.0) & (s > 0.0), s, 0.0)
    return s * 1e-18 * 1e-4  # 1e-18 cm^2 -> m^2


# (h^2 / (2 pi m_e k_B))^1.5 precomputed in float64 on the host: h**2
# ~ 4.4e-67 underflows float32 as a traced intermediate, so the
# temperature-free part must be folded first.
_LAMDB3_C = float((h**2 / (2.0 * np.pi * m_e * k_B)) ** 1.5)  # ~4.1e-22
_CHI_HM_OVER_K = float(_CHI_HMINUS / k_B)


def hminus_saha_factor(T, n_e):
    """LTE n(H-)/n(H I ground-ish): Saha inversion.

    n(H-) = n_HI * n_e * (g_H-/(2 g_HI)) Lambda^3 exp(chi/kT),
    g(H-)=1, g(HI)=2 -> factor 1/4.  Float32-safe grouping: the thermal
    de Broglie constant is host-folded and n_e * 4.1e-22 ~ O(1).
    """
    return (0.25 * _LAMDB3_C) * n_e * T ** -1.5 * jnp.exp(
        jnp.clip(_CHI_HM_OVER_K / T, 0.0, 500.0))


def hminus_bf(lam, T, n_h1, n_e):
    """H- bound-free extinction with stimulated emission [m^-1]."""
    stim = -jnp.expm1(-(h * c_0 / k_B) / (lam * T))
    return hminus_bf_sigma(lam) * hminus_saha_factor(T, n_e) * n_h1 * stim


# -------------------------------------------------------- hydrogenic ff

def gaunt_ff(lam, T):
    """Free-free Gaunt factor, Gray (2005) eq. 8.6."""
    lamR = lam * 1.0968e7
    return 1.0 + 0.3456 / lamR ** (1.0 / 3.0) * (
        lam * k_B * T / (h * c_0) + 0.5)


# 3.6923e-2 / c_0^3 (host-folded): nu**3 ~ 1e46 overflows float32
_HFF_C = float(3.6923e-2 / c_0**3)   # ~1.37e-27


def hydrogenic_ff(nu, T, n_e, n_ion, Z=1):
    """Hydrogenic (H II) free-free extinction [m^-1].

    Kramers formula with stimulated-emission correction; cgs coefficient
    3.6923e8 converted to SI densities/length (3.6923e-2).
    Mirrors Transparency.jl hydrogenic_ff as called at src/radiation.jl:35.
    Float32-safe grouping: 1/nu^3 is rewritten as lam^3/c^3 with the
    constant paired against n_e and lam^3 against n_ion so every
    intermediate stays in float32 range.
    """
    lam = c_0 / nu
    stim = -jnp.expm1(-(h / k_B) * nu / T)
    return ((_HFF_C * n_e) * (lam**3 * n_ion)
            * (Z**2 * gaunt_ff(lam, T) / jnp.sqrt(T)) * stim)


# --------------------------------------------------------------- H2+

# Approximation to Bates (1952); see module docstring and docs/PARITY.md.
_H2P_D0 = 2.65 * 1.602176634e-19    # H2+ dissociation energy [J]
_MU_HP = 0.5 * 1.6726219e-27        # reduced mass of H + p [kg]


# (h^2/(2 pi mu k_B))^1.5 host-folded (h**2 underflows float32)
_H2P_LAMDB3_C = float((h**2 / (2.0 * np.pi * _MU_HP * k_B)) ** 1.5)
_H2P_D0_OVER_K = float(_H2P_D0 / k_B)
# H2+ X^2 Sigma_g+ molecular constants (Herzberg): omega_e ~ 2297 cm^-1,
# B_e ~ 29.8 cm^-1; hc/k_B = 1.4388 cm K
_H2P_THETA_VIB = 2297.0 * 1.4388   # K
_H2P_THETA_ROT = 29.8 * 1.4388     # K


def _h2plus_equilibrium(T, n_h1, n_p):
    """LTE n(H2+) from n(H I) * n(p) via molecular Saha.

    Internal partition function: electronic g=2 (X^2 Sigma_g+) x
    classical rigid rotor with homonuclear symmetry factor 2
    (q_rot = T / (2 Theta_rot)) x harmonic oscillator
    (q_vib = 1/(1 - exp(-Theta_vib/T))) -- standard molecular
    statistical mechanics replacing the reference chain's tabulated
    Bates (1952) equilibrium (the table itself is not vendorable in
    this offline build; error budget in docs/PARITY.md).

    Float32-safe grouping: n_h1 * n_p ~ 1e40 overflows float32, so the
    de Broglie factor is paired with n_h1 first.
    """
    q_rot = T / (2.0 * _H2P_THETA_ROT)
    q_vib = 1.0 / -jnp.expm1(-_H2P_THETA_VIB / T)
    q_int = 2.0 * q_rot * q_vib
    boltz = jnp.exp(jnp.clip(_H2P_D0_OVER_K / T, 0.0, 500.0))
    n_lte = ((_H2P_LAMDB3_C * n_h1) * T ** -1.5) * n_p * 0.5 * q_int * boltz
    # physical pool cap: each H2+ consumes one H I and one proton, so the
    # molecule count can never exceed either parent pool.  For
    # charge-consistent states the LTE value sits far below this; for
    # Saha-inconsistent inputs (n_e decoupled from n_p, docs/PARITY.md
    # section 1 caveat) the cap keeps the share bounded instead of letting
    # a cold-cell Boltzmann factor run away.
    return jnp.minimum(n_lte, jnp.minimum(n_h1, n_p))


def h2plus_bf(lam, T, n_h1, n_p):
    """H2+ photodissociation (1s sigma_g -> 2p sigma_u) extinction [m^-1].

    Cross-section modelled as a log-normal peaked near 110 nm with peak
    2e-18 cm^2 (Dunn 1968 scale); approximation to the Bates (1952) table
    used by the reference.
    """
    sigma = 2e-22 * jnp.exp(-((jnp.log(lam / 110e-9) / 0.25) ** 2))  # m^2
    stim = -jnp.expm1(-(h * c_0 / k_B) / (lam * T))
    return _h2plus_equilibrium(T, n_h1, n_p) * sigma * stim


def h2plus_ff(lam, T, n_h1, n_p):
    """H2+ free-free extinction [m^-1] (Kramers-like long-wavelength rise).

    Normalised to the Bates (1952) magnitude ~2e-49 m^5 per (n_H n_p) at
    1 micron, 6000 K; approximation, see docs/PARITY.md.
    """
    # 2e-49 underflows float32 even as a denormal; split across the two
    # density factors so every intermediate stays in range
    return ((2e-26 * n_h1) * (1e-23 * n_p)
            * (lam / 1e-6) ** 3 * jnp.sqrt(6000.0 / T))


# --------------------------------------------- charge-consistency guard

_CHI_HION_OVER_K = float(h * c_0 * 109677.617e2 / k_B)  # H ionization [K]
_warned_charge = False


def warn_charge_inconsistency(temperature, electron_density,
                              hydrogen_density, factor=100.0, frac=0.01):
    """Warn (once) when n_e sits far below the pure-H Saha expectation.

    The H2+ recipes assume roughly charge-consistent states (n_e ~ n_p);
    when the loaded atmosphere's n_e is more than `factor` below the
    self-consistent Saha proton density over more than `frac` of cells,
    the H2+ *share* of a (tiny) continuum can reach tens of percent
    (docs/PARITY.md section 1 caveat; the pool cap in
    _h2plus_equilibrium bounds the absolute value).  Host-side, cheap,
    called from engine setup.  Returns the offending cell fraction.
    """
    import warnings
    T = np.asarray(temperature, dtype=np.float64).ravel()
    n_e = np.asarray(electron_density, dtype=np.float64).ravel()
    n_H = np.asarray(hydrogen_density, dtype=np.float64).ravel()
    # pure-H charge-consistent Saha: n_p^2 / (n_H - n_p) = phi(T)
    phi = 2.0 * ((2.0 * np.pi * m_e * k_B / h**2) * T) ** 1.5 \
        * np.exp(-np.clip(_CHI_HION_OVER_K / T, None, 690.0))
    n_p_saha = 0.5 * (-phi + np.sqrt(phi * phi + 4.0 * phi * n_H))
    bad = float(np.mean(n_e * factor < n_p_saha))
    global _warned_charge
    if bad > frac and not _warned_charge:
        _warned_charge = True
        warnings.warn(
            f"atmosphere n_e is >{factor:.0f}x below the charge-consistent "
            f"Saha proton density in {100 * bad:.1f}% of cells; the H2+ "
            "continuum recipes assume n_e ~ n_p and their share of the "
            "continuum is unreliable there (docs/PARITY.md section 1)",
            stacklevel=2)
    return bad


# ------------------------------------------------------------ aggregates

def alpha_absorption(lam, T, n_e, n_h_neutral, n_proton):
    """Total thermal-absorption extinction [m^-1].

    Mirrors src/radiation.jl:28-40: H- ff (Stilley->Bell&Berrington) +
    H- bf (Geltman->Wishart) + hydrogenic ff + H2+ ff + H2+ bf.
    """
    a = hminus_ff(lam, T, n_h_neutral, n_e)
    a = a + hminus_bf(lam, T, n_h_neutral, n_e)
    a = a + hydrogenic_ff(c_0 / lam, T, n_e, n_proton, 1)
    a = a + h2plus_ff(lam, T, n_h_neutral, n_proton)
    a = a + h2plus_bf(lam, T, n_h_neutral, n_proton)
    return a


def alpha_scattering(lam, n_e, n_h1):
    """Scattering extinction [m^-1]; mirrors src/radiation.jl:49-56."""
    return thomson(n_e) + rayleigh_h(lam, n_h1)
