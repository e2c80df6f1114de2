"""CUDA kernel for the line recurrence of the regular sweep's marching
cases, called through the XLA foreign function interface.

The kernel (native/march.cu) replaces only the sequential part of
`sweep_regular._march_lines`: the n_sweeps Gauss-Seidel passes of

    buf <- coeff[c] * LI(buf) + const[c]

over the N columns of one z-plane, fed by the pass-invariant
coeff/const arrays XLA computes plane-wide.  One launch per z-plane;
one thread block per (angle * wavelength) line.  Lines are independent,
so on a device mesh the call is partitioned along the line axis: each
device marches only its own lines (`line_partitioned`).

`kernel_selected` decides where it runs: on a GPU backend, for float32
fields.  The shared library is built from tracked sources into the
gitignored native/build/ on first use (`make -C native cuda`); a failed
build or load raises -- there is no fallback on a GPU.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental.custom_partitioning import custom_partitioning
from jax.sharding import NamedSharding, PartitionSpec as P

_NATIVE = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", "native"))
LIB_PATH = os.path.join(_NATIVE, "build", "libvrt_march.so")
MAX_LINE = 4096          # points per line the kernel supports

_registered = False


def kernel_selected(dtype):
    """Whether the march kernel runs: on a GPU backend for float32
    fields."""
    return dtype == jnp.float32 and jax.default_backend() == "gpu"


def build():
    """Compile the kernel library (nvcc, sm_90a) into native/build/."""
    subprocess.run(["make", "-C", _NATIVE, "cuda",
                    f"PYTHON={sys.executable}"], check=True)


def ensure_registered():
    """Build (if absent), load and register the FFI target once."""
    global _registered
    if _registered:
        return
    if not os.path.exists(LIB_PATH):
        build()
    lib = ctypes.cdll.LoadLibrary(LIB_PATH)
    jax.ffi.register_ffi_target("vrt_march", jax.ffi.pycapsule(lib.VrtMarch),
                                platform="CUDA")
    _registered = True


def f_rows(f_line, n_lines, dtype):
    """A scalar or per-line (B, 1) fraction as the kernel's (B,) array."""
    return jnp.broadcast_to(jnp.asarray(f_line, dtype).reshape(-1),
                            (n_lines,))


def _line_axis(sharding):
    """Mesh axes of the line axis (dim 1) of a (N, B, M) operand."""
    if isinstance(sharding, NamedSharding) and len(sharding.spec) > 1:
        return sharding.spec[1]
    return None


def line_partitioned(march):
    """`march(coeff, const, f, s_base, n_sweeps)` on (N, B, M), (N, B, M),
    (B,) operands as an op the SPMD partitioner splits along the line
    axis B only: each device runs `march` on its own lines, whole in the
    march axis N and the line axis M (a column reads its neighbours
    along M, and columns follow each other along N)."""
    fn = custom_partitioning(march, static_argnums=(3, 4))

    def partition(s_base, n_sweeps, mesh, arg_shapes, result_shape):
        axis = _line_axis(arg_shapes[1].sharding)
        plane = NamedSharding(mesh, P(None, axis, None))
        rows = NamedSharding(mesh, P(axis))
        return (mesh, lambda c, k, f: march(c, k, f, s_base, n_sweeps),
                plane, (plane, plane, rows))

    fn.def_partition(partition,
                     sharding_rule="n b m, n b m, b -> n b m",
                     need_replication_factors=("n", "m"))
    return fn


def _ffi_march(coeff, const, f, s_base, n_sweeps):
    return jax.ffi.ffi_call(
        "vrt_march", jax.ShapeDtypeStruct(const.shape, const.dtype))(
            coeff, const, f, s_base=np.int64(s_base),
            n_sweeps=np.int64(n_sweeps))


_march = line_partitioned(_ffi_march)


def march_lines(coeff, const, f_line, s_base, n_sweeps):
    """Lines of the last Gauss-Seidel pass, (N, B, M) float32.

    coeff, const: (N, B, M) float32 in march order; f_line: scalar or
    (B, 1) line-interpolation fraction; s_base: stencil base shift (0 or
    -1)."""
    if const.shape[-1] > MAX_LINE:
        raise ValueError(f"march kernel: line of {const.shape[-1]} points "
                         f"exceeds {MAX_LINE}")
    ensure_registered()
    return _march(coeff, const, f_rows(f_line, const.shape[1], const.dtype),
                  int(s_base), int(n_sweeps))
