"""Statistical equilibrium: batched 2x2 population solve.

Reference parity: src/populations.jl:147-221 (`get_revised_populations`),
which builds a 2x2 system per cell (levels 2..3 unknown, level 1 closed by
mass conservation) and solves with inv(A)*b in a Python-level per-cell
loop.  Here the 2x2 inverse is written out explicitly and applied as a
fully vectorized elementwise expression -- the data-parallel equivalent
of the reference's hot per-cell loop (SURVEY.md §3.1).
"""

import jax.numpy as jnp


def get_revised_populations(R, C, atom_density):
    """Solve statistical equilibrium for the 3-level atom.

    Args:
      R, C: dicts {(i, j): array} of radiative/collisional rates i->j
            (0-based levels, 2 = continuum), each per-cell shaped.
      atom_density: total hydrogen density per cell [m^-3].
    Returns:
      populations: (..., 3) [m^-3].

    System (0-based; mirrors populations.jl:161-168):
      A[0,0] = P01 + P10 + P12        A[0,1] = P01 - P21
      A[1,0] = P02 - P12              A[1,1] = P02 + P20 + P21
      b[0] = n_total P01              b[1] = n_total P02
      unknowns: (n2, n3); n1 = n_total - n2 - n3.
    """
    P = {k: R[k] + C[k] for k in R}

    A00 = P[(0, 1)] + P[(1, 0)] + P[(1, 2)]
    A01 = P[(0, 1)] - P[(2, 1)]
    A10 = P[(0, 2)] - P[(1, 2)]
    A11 = P[(0, 2)] + P[(2, 0)] + P[(2, 1)]

    # n_total is factored out of b so the Cramer numerators stay within
    # float32 range (rate products ~1e26 * n_H ~1e23 would overflow)
    det = A00 * A11 - A01 * A10
    n2 = atom_density * ((A11 * P[(0, 1)] - A01 * P[(0, 2)]) / det)
    n3 = atom_density * ((A00 * P[(0, 2)] - A10 * P[(0, 1)]) / det)
    n1 = atom_density - n2 - n3
    return jnp.stack([n1, n2, n3], axis=-1)
