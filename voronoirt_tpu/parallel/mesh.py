"""Device-mesh distribution of the Lambda iteration.

The reference's only parallelism is shared-memory Julia threads over
wavelengths (lambda_iteration.jl:30,91; SURVEY.md §2 parallelism
inventory).  The equivalents here:

  * wavelength axis ("lam"): pure data parallelism -- each device owns a
    lambda block through profile/opacity/sweep/J; the only cross-shard
    reductions are the rate integrals (sum over lambda) and the
    convergence max, both emitted automatically by GSPMD from jnp
    reductions.
  * horizontal spatial axis ("y"): columnar domain decomposition.  The
    sweep stencils reach +-1 cell in y (jnp.roll), which GSPMD lowers to
    collective-permutes of one-column halos -- the halo-exchange
    design of SURVEY.md §5 "long-context analog" without hand-written
    NCCL-style code.  The sequential z march stays on-chip (the pipeline
    depth axis).
  * the BFS-layered Voronoi sweep shards its site axis the same way
    (gathers become all-gathers only for cross-shard upwind edges).

The angle axis is distributed separately (parallel/angles.py): each
direction compiles its own static sweep schedule, so angle parallelism
is MPMD round-robin over devices rather than a shard_map axis.

Usage: build a mesh, then `shard_regular(engine, mesh)` re-places the
engine's arrays with NamedShardings; every jitted step inherits the
placement.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(axis_sizes, axis_names=("lam", "y"), devices=None):
    """Create a Mesh, e.g. make_mesh((2, 4)) -> 2 lam-shards x 4 y-shards."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    total = int(np.prod(axis_sizes))
    if total > devices.size:
        raise ValueError(f"mesh {axis_sizes} needs {total} devices, "
                         f"have {devices.size}")
    grid = devices[:total].reshape(axis_sizes)
    return Mesh(grid, axis_names[: len(axis_sizes)])


def make_hybrid_mesh(axis_sizes, axis_names, process_axes=("x",),
                     devices=None):
    """Mesh whose `process_axes` span processes and the rest stay within
    one process's devices.

    Layout rule: put the bandwidth-light axis across processes and keep
    the collective-heavy axes among one process's devices.  For this
    framework the spatial "x" axis is the light one -- its only
    collectives are the +-1-column halo permutes of the sweep stencils
    -- while the "lam"/"y" reductions stay inside a process.

    In a true multi-process run (jax.distributed.initialize done,
    jax.process_count() > 1) the grid comes from
    mesh_utils.create_hybrid_device_mesh so each coordinate of the
    process axes is one process's local devices.  In a single process
    (incl. the virtual-CPU test mesh) it reduces to an ordered reshape
    with the process axes slowest-varying -- the same logical layout,
    testable without several processes.
    """
    axis_sizes = tuple(int(s) for s in axis_sizes)
    axis_names = tuple(axis_names)
    if len(axis_sizes) != len(axis_names):
        raise ValueError("axis_sizes and axis_names length mismatch")
    unknown = set(process_axes) - set(axis_names)
    if unknown:
        raise ValueError(f"process_axes {unknown} not in axis_names")
    if jax.process_count() > 1:
        from jax.experimental import mesh_utils
        local_shape = [1 if n in process_axes else s
                       for n, s in zip(axis_names, axis_sizes)]
        across_shape = [s if n in process_axes else 1
                        for n, s in zip(axis_names, axis_sizes)]
        grid = mesh_utils.create_hybrid_device_mesh(
            local_shape, across_shape,
            devices=devices if devices is not None else jax.devices())
        return Mesh(grid, axis_names)
    # single process: process axes outermost so they vary slowest
    order = sorted(range(len(axis_names)),
                   key=lambda i: (axis_names[i] not in process_axes, i))
    inv = np.argsort(order)
    devices = np.asarray(devices if devices is not None else jax.devices())
    total = int(np.prod(axis_sizes))
    if total > devices.size:
        raise ValueError(f"mesh {axis_sizes} needs {total} devices, "
                         f"have {devices.size}")
    grid = devices[:total].reshape([axis_sizes[i] for i in order])
    return Mesh(np.transpose(grid, inv), axis_names)


def _put(x, mesh, spec):
    return jax.device_put(x, NamedSharding(mesh, spec))


def shard_regular(engine, mesh):
    """Re-place a RegularEngine's state on a ("lam", "x", "y") mesh
    (any subset of those axis names).

    Field layouts:  (nlam, nz, nx, ny) -> P("lam", None, "x", "y")
                    (nz, nx, ny)       -> P(None, "x", "y")
    Requires each sharded extent to divide evenly.  "x" is the axis to
    lay across processes (halo-only collectives) in meshes built with
    make_hybrid_mesh.
    """
    lam_ax = "lam" if "lam" in mesh.axis_names else None
    x_ax = "x" if "x" in mesh.axis_names else None
    y_ax = "y" if "y" in mesh.axis_names else None

    engine.T = _put(engine.T, mesh, P(None, x_ax, y_ax))
    engine.ne = _put(engine.ne, mesh, P(None, x_ax, y_ax))
    engine.nH = _put(engine.nH, mesh, P(None, x_ax, y_ax))
    engine.v = _put(engine.v, mesh, P(None, x_ax, y_ax, None))
    engine.lte = _put(engine.lte, mesh, P(None, x_ax, y_ax, None))
    engine.a_cont = _put(engine.a_cont, mesh, P(None, x_ax, y_ax))
    engine.eps = _put(engine.eps, mesh, P(None, x_ax, y_ax))
    engine.B0 = _put(engine.B0, mesh, P(lam_ax, None, x_ax, y_ax))
    engine.C = {k: _put(v, mesh, P(None, x_ax, y_ax))
                for k, v in engine.C.items()}
    engine.mesh = mesh
    return engine


def shard_voronoi(engine, mesh):
    """Re-place a VoronoiEngine's state: site axis on "site" (alias
    "y"/"x" accepted), lambda on "lam".

    Requires n_sites % site-shards == 0 (pad the site set when sampling).
    """
    lam_ax = "lam" if "lam" in mesh.axis_names else None
    y_ax = next((n for n in ("site", "y", "x")
                 if n in mesh.axis_names), None)

    engine.T = _put(engine.T, mesh, P(y_ax))
    engine.ne = _put(engine.ne, mesh, P(y_ax))
    engine.nH = _put(engine.nH, mesh, P(y_ax))
    engine.v = _put(engine.v, mesh, P(y_ax, None))
    engine.lte = _put(engine.lte, mesh, P(y_ax, None))
    engine.a_cont = _put(engine.a_cont, mesh, P(y_ax))
    engine.eps = _put(engine.eps, mesh, P(y_ax))
    engine.B0 = _put(engine.B0, mesh, P(lam_ax, y_ax))
    engine.C = {k: _put(v, mesh, P(y_ax)) for k, v in engine.C.items()}
    engine.mesh = mesh
    return engine
