"""Voigt profile via the Humlicek (1982) w4 rational approximation.

Reference parity: Transparency.jl `voigt_profile` (called from src/line.jl:92,
110,133 and src/rates.jl:388,408), which uses the same Humlicek algorithm.

H(a, v) = Re[w(v + i a)]; profile phi(a, v, dlamD) = H / (sqrt(pi) dlamD).

Accuracy: max relative error ~1e-4 vs scipy.special.wofz (tested in
tests/test_voigt.py), identical algorithm family to the reference.
All-region evaluation + jnp.where selection keeps the function jit/vmap
friendly (no data-dependent branching).
"""

import jax.numpy as jnp
import numpy as np

_SQRT_PI = float(np.sqrt(np.pi))


def humlicek_w(a, v):
    """Complex probability function w(z), z = v + i a, for a >= 0.

    Complex dtype follows the input on every backend: complex128 for
    float64 inputs (exactness for the oracle tests), complex64 for
    float32.
    """
    import jax
    rdtype = (jnp.float64 if jnp.result_type(a, v) == jnp.float64
              else jnp.float32)
    # Humlicek works with t = a - i v, built with lax.complex from
    # same-width reals: the eager form (a - 1j*v).astype(c64) would
    # promote a float32 run through complex128 under x64.
    t = jax.lax.complex(jnp.asarray(a, dtype=rdtype),
                        -jnp.asarray(v, dtype=rdtype))
    s = jnp.abs(v) + a

    # Region I: s >= 15
    w1 = t * 0.5641896 / (0.5 + t * t)

    # Region II: 5.5 <= s < 15
    u2 = t * t
    w2 = t * (1.410474 + u2 * 0.5641896) / (0.75 + u2 * (3.0 + u2))

    # Region III: s < 5.5 and a >= 0.195|v| - 0.176
    w3 = (16.4955 + t * (20.20933 + t * (11.96482 + t * (3.778987 + t * 0.5642236)))) / (
        16.4955 + t * (38.82363 + t * (39.27121 + t * (21.69274 + t * (6.699398 + t))))
    )

    # Region IV: s < 5.5 and a < 0.195|v| - 0.176
    u4 = t * t
    # clip the real part of u4 so exp never overflows in the unselected
    # branch (lax.complex: dtype-preserving, no c128 promotion)
    import jax
    u4c = jax.lax.complex(jnp.clip(jnp.real(u4), -690.0, 690.0),
                          jnp.imag(u4))
    numer = t * (36183.31 - u4 * (3321.9905 - u4 * (1540.787 - u4 * (
        219.0313 - u4 * (35.76683 - u4 * (1.320522 - u4 * 0.56419))))))
    denom = 32066.6 - u4 * (24322.84 - u4 * (9022.228 - u4 * (
        2186.181 - u4 * (364.2191 - u4 * (61.57037 - u4 * (1.841439 - u4))))))
    w4 = jnp.exp(u4c) - numer / denom

    w = jnp.where(s >= 15.0, w1,
        jnp.where(s >= 5.5, w2,
        jnp.where(a >= 0.195 * jnp.abs(v) - 0.176, w3, w4)))
    return w


def voigt_H(a, v):
    """Voigt function H(a, v) = Re[w(v + i a)]."""
    return jnp.real(humlicek_w(a, v))


def voigt_profile(a, v, dlamD):
    """Normalized Voigt profile [1/m].

    Args:
      a: damping parameter (dimensionless)
      v: (lam - lam0 + lam0*v_los/c) / dlamD (dimensionless)
      dlamD: Doppler width [m]

    Mirrors Transparency.jl voigt_profile as used at src/line.jl:92.
    """
    return voigt_H(a, v) / (_SQRT_PI * dlamD)


def doppler_profile(dlam, dlamD):
    """Pure Doppler profile [1/m]; mirrors src/line.jl:165-167."""
    return jnp.exp(-((dlam / dlamD) ** 2)) / (_SQRT_PI * dlamD)
