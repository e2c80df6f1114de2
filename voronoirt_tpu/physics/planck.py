"""Planck functions.

Reference parity: src/radiation.jl:7-19 (`B_ν`, `B_λ`).
Intensity unit: kW m^-2 nm^-1 (constants.IUNIT_SI); see constants module.
"""

import jax.numpy as jnp
import numpy as np

from ..constants import h, c_0, k_B, IUNIT_SI

# float32-safe groupings: every constant that would under/overflow float32
# as a bare intermediate (h*c_0/k_B ~ 1e-2 is fine; 2 h c_0^2 / IUNIT_SI
# ~ 1e-28 is fine; but lam**5 ~ 1e-39 and lam*k_B ~ 1e-30 are below the
# float32 normal range and flush to zero wherever denormals are flushed,
# which turns B into inf/inf = NaN at the 22.8 nm bound-free
# wavelengths).  The prefactor is therefore evaluated in log space and
# x with the (h c/k_B)/(lam T) grouping.  Mathematically identical; f64
# agreement ~1e-15 relative (tests/test_f32_physics.py).
_HC_OVER_K = float(h * c_0 / k_B)                     # ~1.44e-2 m K
_LOG_2HC2_IUNIT = float(np.log(2.0 * h * c_0**2 / IUNIT_SI))


def B_lambda(lam, T):
    """Planck spectral radiance per wavelength.

    Args:
      lam: wavelength [m] (scalar or array, broadcastable with T)
      T: temperature [K]
    Returns:
      B_lambda in kW m^-2 nm^-1 (== 1e12 W m^-3).

    Mirrors src/radiation.jl:17-19; float32-safe (see module constants).
    expm1 overflow at large x yields inf -> B = finite/inf = 0, the
    mathematically correct tail.
    """
    x = _HC_OVER_K / (lam * T)
    x = jnp.clip(x, 1e-9, None)
    prefac = jnp.exp(_LOG_2HC2_IUNIT - 5.0 * jnp.log(lam))
    return prefac / jnp.expm1(x)


def B_nu(nu, T):
    """Planck spectral radiance per frequency [W m^-2 Hz^-1 sr^-1] (SI).

    Mirrors src/radiation.jl:7-9.  nu**3 ~ 1e46 overflows float32, so the
    prefactor is evaluated in log space (float32-safe grouping).
    """
    x = (h / k_B) * nu / T
    x = jnp.clip(x, 1e-9, None)
    prefac = jnp.exp(float(np.log(2.0 * h / c_0**2)) + 3.0 * jnp.log(nu))
    return prefac / jnp.expm1(x)
