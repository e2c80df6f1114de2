"""Runtime platform setup: backend, precision, persistent compile cache.

Every entry point (drivers, bench.py, chip_smoke.py, the analysis
benches) calls `setup` before its first computation.
"""

from __future__ import annotations

import os

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# accepted platform request -> (jax_platforms value, default_backend())
_PLATFORMS = {"cpu": ("cpu", "cpu"), "gpu": ("cuda", "gpu"),
              "cuda": ("cuda", "gpu")}


def compile_cache_dir(environ=None):
    """The persistent compilation cache directory in use.

    JAX_COMPILATION_CACHE_DIR when set (JAX reads it itself); otherwise
    the fixed `<checkout>/.cache/jax`, so every process of this
    checkout shares one cache."""
    environ = os.environ if environ is None else environ
    return (environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(_ROOT, ".cache", "jax"))


def setup(platform=None, x64=True, n_cpu_devices=None):
    """Configure jax before first use.

    Args:
      platform: "cpu" / "gpu" / None (keep the default backend).  If the
        backend is already up and differs from the request, raises
        RuntimeError rather than run on another device.
      x64: enable float64 (the physics layer needs f64 ranges; the
        transport kernels run float32 regardless).
      n_cpu_devices: virtual CPU device count (for mesh tests).
    Returns:
      the active backend name (jax.default_backend()).
    """
    import jax

    if n_cpu_devices:
        jax.config.update("jax_num_cpu_devices", int(n_cpu_devices))
    if platform:
        if platform not in _PLATFORMS:
            raise ValueError(f"unknown platform {platform!r}; "
                             f"expected one of {sorted(_PLATFORMS)}")
        jax_name, backend = _PLATFORMS[platform]
        previous = jax.config.jax_platforms
        try:
            jax.config.update("jax_platforms", jax_name)
        except RuntimeError:
            pass        # backend already initialized: checked below
        try:
            active = jax.default_backend()
        except (RuntimeError, AssertionError) as e:
            # JAX asserts when no listed platform initializes
            raise RuntimeError(f"platform {platform!r} requested but no "
                               f"backend for it initializes") from e
        if active != backend:
            jax.config.update("jax_platforms", previous)
            raise RuntimeError(f"platform {platform!r} requested but the "
                               f"active backend is {active!r}")
    jax.config.update("jax_enable_x64", bool(x64))
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        cache = compile_cache_dir()
        os.makedirs(cache, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", cache)
        jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return jax.default_backend()


def distributed_init(coordinator_address=None, num_processes=None,
                     process_id=None):
    """Join a multi-process run.

    Call once per process before any computation; afterwards
    jax.devices() is the global device set and
    parallel.make_hybrid_mesh lays its process axes across processes.
    No-op when the environment provides no coordination info and no
    explicit arguments are given (single-process runs).  Without a
    cluster manager, give the coordinator address, the process count
    and this process's id (explicitly or through the environment).
    """
    import warnings
    import jax

    # manual launch coordinates from the environment (see README
    # "Multi-process launch"): VRT_* take precedence, then the JAX names
    if coordinator_address is None:
        coordinator_address = (os.environ.get("VRT_COORDINATOR")
                               or os.environ.get("JAX_COORDINATOR_ADDRESS")
                               or os.environ.get("COORDINATOR_ADDRESS"))
    if num_processes is None and os.environ.get("VRT_NUM_PROCESSES"):
        num_processes = int(os.environ["VRT_NUM_PROCESSES"])
    if process_id is None and os.environ.get("VRT_PROCESS_ID"):
        process_id = int(os.environ["VRT_PROCESS_ID"])

    explicit = coordinator_address or num_processes or process_id is not None
    if not explicit:
        return  # single process
    try:
        jax.distributed.initialize(coordinator_address=coordinator_address,
                                   num_processes=num_processes,
                                   process_id=process_id)
    except RuntimeError as e:
        # backend already up (or already initialized): keep running
        # single-process rather than abort
        warnings.warn(f"distributed_init skipped: {e}")
