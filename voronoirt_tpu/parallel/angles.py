"""Angle (quadrature) parallelism: distribute per-angle pipelines.

SURVEY.md §2 parallelism inventory: the reference iterates the 12
quadrature directions serially (lambda_iteration.jl:23,84); the
equivalent here makes the angle set a first-class parallel axis
-- each chip owns a subset of the directions and the weighted J
accumulation reduces across them.

Because every direction has its OWN statically compiled sweep schedule
(per-direction plane cases / layer orderings -- see
solvers/sweep_regular.py build_plan), the angle axis is MPMD, not SPMD:
a shard_map program must be identical on every device, but two angles
generally compile to different programs.  So angles are round-robined
over the device list, the per-angle pipeline (LOS Voigt profile ->
alpha_tot -> formal solution -> weighted accumulate) is dispatched
asynchronously to each owning device (XLA dispatch is non-blocking, so
all devices compute concurrently), and the per-device partial J arrays
are summed on the lead device -- the reduction the reference performs
implicitly in its serial loop.

Composition with the ("lam", "y") mesh of parallel/mesh.py: the two are
alternatives on the same chips (angle MPMD replicates fields per
device; the mesh shards them).  Use the mesh when the grid exceeds one
chip, angle distribution when it fits -- 12 angles / N devices is the
pure-win reduction of SURVEY.md §5 (J is a linear angle sum).

Usage:
    eng = RegularEngine(atmos, line, cfg)
    distribute_angles(eng, jax.devices()[:4])
    eng.run()          # compute_J now fans angles out over 4 devices
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def distribute_angles(engine, devices):
    """Assign the engine's quadrature angles round-robin to `devices`.

    Pre-places the per-run static per-angle inputs (velocities, continuum
    extinction, boundary temperature) on every participating device;
    per-iteration state (S, populations, damping) is broadcast by
    compute_J each iteration.
    """
    devices = tuple(devices)
    static = {}
    for d in devices:
        static[d] = {
            "v": jax.device_put(engine.v, d),
            "a_cont": jax.device_put(engine.a_cont, d),
        }
        if hasattr(engine, "atmos"):           # regular grid
            static[d]["T_bottom"] = jax.device_put(engine.T[0], d)
        else:                                  # voronoi grid
            static[d]["T"] = jax.device_put(engine.T, d)
    engine.angle_devices = devices
    engine._angle_static = static
    return engine


def angle_device(engine, i):
    """Owning device of quadrature angle i (round-robin)."""
    devs = engine.angle_devices
    return devs[i % len(devs)]


def broadcast_state(devices, **arrays):
    """Replicate per-iteration arrays onto every angle device."""
    return {d: {k: jax.device_put(v, d) for k, v in arrays.items()}
            for d in devices}


def reduce_partials(partials, target_device):
    """Sum per-device partial J arrays on the target device.

    The transfer is the explicit analog of the psum the serial loop
    performs implicitly; len(partials) <= n_devices arrays move once.
    """
    total = None
    for p in partials.values():
        p = jax.device_put(p, target_device)
        total = p if total is None else total + p
    return total


def target_device(reference_array):
    """Device holding a (single-device) reference array, for placing J."""
    try:
        devs = list(reference_array.devices())
        if len(devs) == 1:
            return devs[0]
    except Exception:
        pass
    return jax.devices()[0]


def partial_accumulate(partials, device, value):
    """Accumulate a weighted sweep result into a device's partial J."""
    if device in partials:
        partials[device] = partials[device] + value
    else:
        partials[device] = value
