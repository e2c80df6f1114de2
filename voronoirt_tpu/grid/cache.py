"""Disk cache for tessellations and per-direction sweep plans.

The reference persists its tessellation to neighbours.txt and re-reads
it on every run and on resume (src/functions.jl:13-23, src/io.jl:8-40,
recover_simulation.jl:253).  Here the same role is played by a binary
content-addressed cache: the native tessellation (~9 min at 3.5e6
sites on this 2-core host) and the 12-direction plan build (~2-7 min)
are paid once per (sites, quadrature, config) and every later launch --
including crash resume -- reaches its first sweep in seconds.

Keys are sha256 over the exact inputs that determine the output:
  tessellation:  positions bytes + bounds            (max_nb excluded:
                 the neighbour matrix is overflow-doubled to convergence
                 and does not depend on the initial guess)
  plan:          sites key + direction k + up + p + compat + order
                 + n_sweeps
plus a format-version salt, so stale caches from older layouts miss
instead of mis-loading.  Files are plain .npz (uncompressed: load time
matters more than the ~2x size, and geometry entropy compresses poorly).
"""

from __future__ import annotations

import hashlib
import os
import tempfile

import numpy as np

CACHE_VERSION = 1
# plans version independently: schedule-construction changes (cap
# model, segmentation) must miss old plan entries without invalidating
# the far more expensive tessellation entries
PLAN_VERSION = 3

_PLAN_ARRAYS = ("layer_sites", "upwind", "weights", "r", "bc_sites",
                "exact_levels", "relax_levels", "gs_levels", "gs_up_occ")


def default_cache_dir():
    d = os.environ.get("VRT_CACHE_DIR")
    if d:
        return d
    root = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(root, ".cache", "vrt")


def sites_key(positions, bounds):
    h = hashlib.sha256()
    h.update(b"vrt-tess-v%d" % CACHE_VERSION)
    h.update(np.ascontiguousarray(positions, dtype=np.float64).tobytes())
    h.update(np.asarray(bounds, dtype=np.float64).tobytes())
    return h.hexdigest()[:24]


def plan_key(skey, k, up, p, compat, order, n_sweeps):
    h = hashlib.sha256()
    h.update(b"vrt-plan-v%d" % PLAN_VERSION)
    h.update(skey.encode())
    h.update(np.asarray(k, dtype=np.float64).tobytes())
    h.update(("%d|%r|%s|%s|%d" % (int(up), float(p), compat, order,
                                  int(n_sweeps))).encode())
    return h.hexdigest()[:24]


def _atomic_savez(path, **arrays):
    """Write-then-rename so a crashed writer never leaves a truncated
    cache entry that a later run would try to load."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise


def load_tessellation(cache_dir, skey):
    """-> (neighbours, layers_up, layers_down) or None."""
    path = os.path.join(cache_dir, "tess-%s.npz" % skey)
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            return (z["neighbours"], z["layers_up"], z["layers_down"])
    except Exception:
        return None


def save_tessellation(cache_dir, skey, neighbours, layers_up, layers_down):
    _atomic_savez(os.path.join(cache_dir, "tess-%s.npz" % skey),
                  neighbours=neighbours, layers_up=layers_up,
                  layers_down=layers_down)


def load_plan(cache_dir, pkey):
    """-> dict of plan fields or None."""
    path = os.path.join(cache_dir, "plan-%s.npz" % pkey)
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            out = {name: z[name] for name in _PLAN_ARRAYS if name in z}
            out["relax_repeats"] = int(z["relax_repeats"])
            out["n"] = int(z["n"])
            for name in _PLAN_ARRAYS:
                out.setdefault(name, None)
            return out
    except Exception:
        return None


def save_plan(cache_dir, pkey, plan):
    arrays = {"relax_repeats": np.int64(plan.relax_repeats),
              "n": np.int64(plan.n)}
    for name in _PLAN_ARRAYS:
        a = getattr(plan, name)
        if a is not None:
            arrays[name] = a
    _atomic_savez(os.path.join(cache_dir, "plan-%s.npz" % pkey), **arrays)
