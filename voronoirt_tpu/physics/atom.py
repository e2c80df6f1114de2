"""Hydrogenic two-level-plus-continuum atom and wavelength sampling.

Reference parity: src/line.jl (HydrogenicLine struct/ctor :14-72,
sample_lambda_line :259-305 [RH log sampling], sample_lambda_boundfree
:316-345, transition_lambda :354-356, test_atom :232-247, destruction
:367-376, source_line :383-395, line extinction alphaline :219-225,
line-of-sight velocity :175-208, Voigt profile assembly :80-137).

The line is a host-side dataclass of Python floats + numpy wavelength
grids; the per-cell Doppler width dlamD is an array.  It is a pytree
whose only leaf is dlamD: jitted functions take the line as an ordinary
argument, so the per-cell field is traced (not baked into every compiled
program as a constant) and the host-side fields key the compile cache.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import h, c_0, k_B, e, eps_0, m_e, hc, mass_H, IUNIT_SI
from .planck import B_lambda
from .voigt import voigt_profile


def wavenumber_to_energy(chi_cm):
    """cm^-1 -> J (Transparency.jl wavenumber_to_energy)."""
    return hc * chi_cm * 100.0


def transition_lambda(chi1, chi2):
    """Wavelength [m] of the chi1->chi2 energy gap (src/line.jl:354-356)."""
    return hc / (chi2 - chi1)


def calc_Aji(lam0, g_ratio, f_value):
    """Einstein A from the oscillator strength.

    A_ul = 2 pi e^2 / (eps0 m_e c lam0^2) * (g_l/g_u) * f   [s^-1]
    (Transparency.jl calc_Aji; gives 4.70e8 s^-1 for Ly-alpha.)
    """
    return (2.0 * np.pi * e**2 / (eps_0 * m_e * c_0 * lam0**2)
            * g_ratio * f_value)


def calc_Bji(lam0, Aji):
    """Einstein B (stimulated emission, per J_lambda in SI W m^-3)."""
    return Aji * lam0**5 / (2.0 * h * c_0**2)


def sample_lambda_line(nlam, lam0, qwing=600.0, qcore=15.0):
    """RH-style logarithmic bb wavelength grid [m].

    Mirrors src/line.jl:259-305 (from github.com/ITA-Solar/rh
    getlambda.c): forced odd count, vmicro_char = 2.5 km/s.
    """
    if nlam > 0 and nlam % 2 == 0:
        nlam += 1
    if 1 < nlam < 5:
        nlam = 5
    lam = np.empty(nlam, dtype=np.float64)
    if nlam == 1:
        lam[0] = lam0
        return lam
    vmicro_char = 2.5e3  # m/s
    n = nlam / 2.0
    beta = qwing / (2.0 * qcore)
    y = beta + np.sqrt(beta * beta + (beta - 1.0) * n + 2.0 - 3.0 * beta)
    b = 2.0 * np.log(y) / (n - 1.0)
    a = qwing / (n - 2.0 + y * y)
    center = nlam // 2
    lam[center] = lam0
    q_to_lam = lam0 * vmicro_char / c_0
    for w in range(1, nlam // 2 + 1):
        dlam = a * (w + (np.exp(b * w) - 1.0)) * q_to_lam
        lam[center - w] = lam0 - dlam
        lam[center + w] = lam0 + dlam
    return lam


def sample_lambda_boundfree(nlam, lam_min, chi_l, chi_inf):
    """Linearly sampled bf wavelength grid [m] (src/line.jl:316-345)."""
    lam_max = transition_lambda(chi_l, chi_inf)
    if nlam == 1:
        return np.array([lam_max])
    return np.linspace(lam_min, lam_max, nlam)


@dataclasses.dataclass(frozen=True, eq=False)
class HydrogenicLine:
    """Two-level-plus-continuum hydrogenic line (src/line.jl:14-72).

    Energies in J, wavelengths in m; Bij/Bji per SI J_lambda [W m^-3]
    (multiply intensities in IUNIT by constants.IUNIT_SI before use, or
    use the *_iunit properties).

    Registered as a pytree below: dlamD is the leaf, every other field
    is static metadata.
    """
    Aji: float
    Bji: float
    Bij: float
    lam0: float
    lam: np.ndarray          # (nlam,) wavelengths [m]
    lam_idx: tuple           # (0, n_bb, n_bb+n_bf, n_bb+2 n_bf)
    chi_i: float
    chi_j: float
    chi_inf: float
    g_i: int
    g_j: int
    f_value: float
    atom_weight: float
    Z: int
    dlamD: jnp.ndarray       # Doppler width per cell [m]

    @property
    def n_lambda(self):
        return len(self.lam)

    @property
    def Bji_iunit(self):
        """Bji per intensity in IUNIT (kW m^-2 nm^-1)."""
        return self.Bji * IUNIT_SI

    @property
    def Bij_iunit(self):
        return self.Bij * IUNIT_SI

    def with_temperature(self, temperature):
        """Return a copy with dlamD recomputed for a new grid."""
        dlamD = doppler_width(self.lam0, self.atom_weight, temperature)
        return dataclasses.replace(self, dlamD=dlamD)


def _line_flatten(line):
    meta = tuple((f.name, tuple(line.lam) if f.name == "lam"
                  else getattr(line, f.name))
                 for f in dataclasses.fields(line) if f.name != "dlamD")
    return (line.dlamD,), meta


def _line_unflatten(meta, leaves):
    fields = dict(meta)
    fields["lam"] = np.asarray(fields["lam"])
    return HydrogenicLine(dlamD=leaves[0], **fields)


jax.tree_util.register_pytree_node(HydrogenicLine, _line_flatten,
                                   _line_unflatten)


def doppler_width(lam0, atom_weight, temperature):
    """Doppler width dlamD = lam0/c sqrt(2kT/m) [m] (Transparency.jl)."""
    return lam0 / c_0 * jnp.sqrt(2.0 * k_B * temperature / atom_weight)


def lyman_alpha_line(nlam_bb, nlam_bf, temperature):
    """H Ly-alpha test atom (src/line.jl:232-247) bound to a temperature
    field (for the Doppler-width array)."""
    chi_l = wavenumber_to_energy(0.0)
    chi_u = wavenumber_to_energy(82258.211)
    chi_inf = wavenumber_to_energy(109677.617)
    return make_line(chi_u, chi_l, chi_inf, nlam_bb, nlam_bf,
                     g_u=8, g_l=2, f_value=4.162e-1,
                     atom_weight=mass_H, Z=1, temperature=temperature)


def make_line(chi_u, chi_l, chi_inf, nlam_bb, nlam_bf, g_u, g_l, f_value,
              atom_weight, Z, temperature):
    """Build a HydrogenicLine (ctor logic of src/line.jl:31-71)."""
    assert chi_inf > chi_u > chi_l
    assert g_u > 0 and g_l > 0 and f_value > 0

    lam0 = transition_lambda(chi_l, chi_u)
    lam_bb = sample_lambda_line(nlam_bb, lam0)
    n_bb = len(lam_bb)
    # bf grids "from Ida" (src/line.jl:52-58): both levels use chi_l's edge
    # for the minimum-wavelength scaling.
    lam1_min = transition_lambda(chi_l, chi_inf) * (1.0 / 2.0) ** 2 + 0.001e-9
    lam2_min = transition_lambda(chi_l, chi_inf) * (2.0 / 2.0) ** 2 + 0.001e-9
    lam_bf_l = sample_lambda_boundfree(nlam_bf, lam1_min, chi_l, chi_inf)
    lam_bf_u = sample_lambda_boundfree(nlam_bf, lam2_min, chi_u, chi_inf)
    lam = np.concatenate([lam_bb, lam_bf_l, lam_bf_u])
    lam_idx = (0, n_bb, n_bb + nlam_bf, n_bb + 2 * nlam_bf)

    Aul = calc_Aji(lam0, g_l / g_u, f_value)
    Bul = calc_Bji(lam0, Aul)
    Blu = g_u / g_l * Bul
    dlamD = doppler_width(lam0, atom_weight, temperature)

    return HydrogenicLine(
        Aji=float(Aul), Bji=float(Bul), Bij=float(Blu), lam0=float(lam0),
        lam=lam, lam_idx=lam_idx, chi_i=float(chi_l), chi_j=float(chi_u),
        chi_inf=float(chi_inf), g_i=g_l, g_j=g_u, f_value=float(f_value),
        atom_weight=float(atom_weight), Z=Z, dlamD=dlamD)


def pad_line(line, n_lambda):
    """Pad the wavelength grid to n_lambda by duplicating the last point.

    Sharding helper: the lambda axis must divide the mesh's "lam" axis;
    padded wavelengths ride through profiles/sweeps as ordinary batch
    entries and are ignored by the rate integrals (whose windows are the
    static lam_idx head slices).
    """
    extra = n_lambda - len(line.lam)
    if extra < 0:
        raise ValueError("cannot shrink the wavelength grid")
    if extra == 0:
        return line
    lam = np.concatenate([line.lam, np.repeat(line.lam[-1:], extra)])
    return dataclasses.replace(line, lam=lam)


# ------------------------------------------------------- per-cell fields

def line_of_sight_velocity(velocity_zxy, k):
    """v_los = v . k for field components stacked last (..., 3) [m/s].

    k ordered (k_z, k_x, k_y); mirrors src/line.jl:175-208.
    """
    k = jnp.asarray(k)
    return (velocity_zxy[..., 0] * k[0] + velocity_zxy[..., 1] * k[1]
            + velocity_zxy[..., 2] * k[2])


def compute_profile(line, lam, damping_lam, v_los):
    """Voigt profile [1/m] for wavelengths `lam` (nlam,) over a cell field.

    v = (lam - lam0 + lam0 v_los / c) / dlamD, evaluated with -k LOS
    velocity already folded into v_los by the caller (the reference's
    "remember to use -k" note, src/line.jl:85).

    Shapes: lam (nlam,), damping_lam (nlam, ...), v_los (...),
    returns (nlam, ...).
    """
    lam = jnp.asarray(lam)
    nl = lam.shape[0]
    shape = (nl,) + (1,) * v_los.ndim
    lam_b = lam.reshape(shape)
    v = (lam_b - line.lam0 + line.lam0 * v_los[None] / c_0) / line.dlamD[None]
    return voigt_profile(damping_lam, v, line.dlamD[None])


def alpha_line(line, profile, n_j, n_i):
    """Line extinction [m^-1] (src/line.jl:219-225).

    alpha = h c/(4 pi lam0) * phi * (n_i Bij - n_j Bji), all SI.
    """
    const = hc / (4.0 * np.pi * line.lam0)
    return const * profile * (n_i * line.Bij - n_j * line.Bji)


def destruction(lte_pops, electron_density, temperature, line, boost=2.0e9):
    """Photon destruction probability eps_lam0 (Rutten 3.98).

    Mirrors src/line.jl:367-376: C21 (with the reference's collisional
    BOOST folded in via `boost`), evaluated at line centre only and then
    frozen for the whole Lambda iteration (reference behaviour).
    """
    from .collisions import coll_exc_hydrogen_johnson
    A21 = line.Aji
    B21_iunit = line.Bji_iunit
    C12 = coll_exc_hydrogen_johnson(1, 2, electron_density, temperature)
    # downward rate by LTE detailed balance (rates.jl Cij i>j branch)
    C21 = C12 * lte_pops[..., 0] / lte_pops[..., 1] * boost
    B_lam0 = B_lambda(line.lam0, temperature)
    return C21 / (C21 + A21 + B21_iunit * B_lam0)


def source_line(line, populations):
    """Line source function from level populations (src/line.jl:383-395).

    Returns S in IUNIT; populations[..., 0]=n_l, [..., 1]=n_u.
    """
    gl, gu = 2.0, 8.0
    nl = populations[..., 0]
    nu = populations[..., 1]
    ratio = gu * nl / (gl * nu)
    return 2.0 * h * c_0**2 / line.lam0**5 / (ratio - 1.0) / IUNIT_SI
