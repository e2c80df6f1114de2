"""voronoirt_tpu: 3D NLTE radiative transfer on accelerators.

A from-scratch JAX/XLA framework with the capabilities of
meudnaes/VoronoiRT (irregular Voronoi + regular-grid short-characteristics
NLTE radiative transfer for stellar atmospheres; arXiv:2306.01041),
redesigned for data-parallel devices:

  * static per-direction sweep plans -> fixed-shape XLA kernels
  * wavelength/angle as vectorized + sharded batch axes
  * functional Lambda-iteration engine under jit
  * C++ native preprocessing (periodic Voronoi neighbour finder, BFS
    wavefront layering) behind a ctypes API

See SURVEY.md for the reference layer map this build follows.
"""

from .config import Config, DEFAULT
from .quadrature import Quadrature, get_quadrature
from .atmosphere import (Atmosphere, get_atmos, synthetic_atmosphere,
                         searchlight_atmosphere, atmosphere_with_ghosts)

__version__ = "0.1.0"
