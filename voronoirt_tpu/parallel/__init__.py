"""Distribution over device meshes (SURVEY.md §2 parallelism inventory)."""

from .mesh import make_mesh, make_hybrid_mesh, shard_regular, shard_voronoi
from .angles import distribute_angles
