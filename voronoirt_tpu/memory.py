"""Memory budgets derived from the device's capacity.

Every budget that bounds a working set (the angle-group stack of the
regular sweep, the in-flight outputs of the angle loop, the hoisted
relax-lap weights of the Voronoi sweep) is a fraction of the first
device's `memory_stats()["bytes_limit"]`, and element counts follow the
dtype's size.  The CPU backend reports no limit; there the arrays live
in host memory, so the host's physical memory stands in.

Each function takes an explicit `limit` so callers (and tests) can ask
what a budget would be on another device.
"""

from __future__ import annotations

import os

# A batched angle-group sweep holds about this many times its stacked
# (P x chunk) extinction field in XLA temporaries -- on an H100 at
# 215x256x256, lambda-chunk 13, 4-angle groups: peak 21.7 GB = the 5.1 GB
# S buffer + ~5.7x the 2.9 GB stack -- and a third of the device is
# given to it.
GROUP_TEMP_FACTOR = 6


def bytes_limit(device=None):
    """Bytes the allocator may hand out on `device` (default: the first
    device)."""
    import jax
    d = device if device is not None else jax.devices()[0]
    stats = d.memory_stats() or {}
    limit = stats.get("bytes_limit")
    if limit:
        return int(limit)
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def group_stack_bytes(limit=None):
    """Ceiling on one angle group's stacked (P x chunk) field bytes."""
    limit = bytes_limit() if limit is None else limit
    return limit // (3 * GROUP_TEMP_FACTOR)


def inflight_bytes(limit=None):
    """Dispatched-but-unconsumed sweep outputs allowed before the angle
    loop waits for the device."""
    limit = bytes_limit() if limit is None else limit
    return limit // 16


def hoist_bytes(limit=None):
    """Budget for a relax stage's precomputed lean weights (Voronoi)."""
    limit = bytes_limit() if limit is None else limit
    return 2 * limit // 5


def lean_chunk_rows(n_lanes, itemsize, limit=None):
    """Slot rows per call of the lean-weight precompute: each row holds
    3 lanes of n_lanes values, and a call's outputs stay near 1/32 of
    the device."""
    limit = bytes_limit() if limit is None else limit
    return max(1, (limit // 32) // (3 * n_lanes * itemsize))


def budgets(n_lanes, itemsize, limit=None):
    """All derived budgets, for reporting."""
    limit = bytes_limit() if limit is None else limit
    return {"bytes_limit": limit,
            "group_stack_bytes": group_stack_bytes(limit),
            "inflight_bytes": inflight_bytes(limit),
            "hoist_bytes": hoist_bytes(limit),
            "lean_chunk_rows": lean_chunk_rows(n_lanes, itemsize, limit)}
