// In-plane line march of the regular-grid sweep (yz/xz plane cuts),
// called from JAX through the XLA foreign function interface
// (voronoirt_tpu/solvers/march_cuda.py).
//
// The plain form (solvers/sweep_regular.py, _march_scan) is the
// recurrence, per line b and column c of the march order,
//
//     buf <- coeff[c, b, :] * LI(buf) + cnst[c, b, :]
//     LI(buf)[y] = (1 - f[b]) * buf[y + s] + f[b] * buf[y + s + 1]   (mod M)
//
// run for n_sweeps passes over the N columns with the line buffer kept
// across passes; the last pass's lines are the output.  coeff/cnst are
// computed plane-wide by XLA.  Here one thread block owns one line (its
// threads span the M points of the line), the buffer lives in shared
// memory (double-buffered: one barrier per column), and the
// coefficients of the next kDepth columns are prefetched into
// registers while the current column is computed.
//
// Build: make -C native cuda   (-> native/build/libvrt_march.so)

#include <cstdint>
#include <string>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kDepth = 4;        // prefetch distance in columns
constexpr int kMaxPerThread = 4; // line points per thread (M <= 4096)

__global__ void march_kernel(const float* __restrict__ coeff,
                             const float* __restrict__ cnst,
                             const float* __restrict__ f_rows,
                             float* __restrict__ out, int n_cols,
                             int n_lines, int m, int s_base, int n_sweeps) {
  extern __shared__ float smem[];
  float* rd = smem;
  float* wr = smem + m;
  const int b = blockIdx.x;
  const float f = f_rows[b];
  const float g = 1.0f - f;
  const size_t col_stride = static_cast<size_t>(n_lines) * m;
  const size_t line_off = static_cast<size_t>(b) * m;
  const int nt = blockDim.x;

  int ys[kMaxPerThread], i0[kMaxPerThread], i1[kMaxPerThread];
  bool on[kMaxPerThread];
#pragma unroll
  for (int j = 0; j < kMaxPerThread; ++j) {
    const int y = threadIdx.x + j * nt;
    on[j] = y < m;
    ys[j] = y;
    i0[j] = ((y + s_base) % m + m) % m;
    i1[j] = ((y + s_base + 1) % m + m) % m;
    if (on[j]) rd[y] = 0.0f;
  }
  __syncthreads();

  const int total = n_sweeps * n_cols;
  const int last_pass = (n_sweeps - 1) * n_cols;
  float cq[kDepth][kMaxPerThread], kq[kDepth][kMaxPerThread];
#pragma unroll
  for (int d = 0; d < kDepth; ++d) {
    if (d < total) {
      const size_t off = static_cast<size_t>(d % n_cols) * col_stride + line_off;
#pragma unroll
      for (int j = 0; j < kMaxPerThread; ++j) {
        if (on[j]) {
          cq[d][j] = coeff[off + ys[j]];
          kq[d][j] = cnst[off + ys[j]];
        }
      }
    }
  }

  for (int t0 = 0; t0 < total; t0 += kDepth) {
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
      const int t = t0 + d;
      if (t < total) {  // uniform across the block
        const int c = t % n_cols;
        const bool emit = t >= last_pass;
        const size_t out_off = static_cast<size_t>(c) * col_stride + line_off;
#pragma unroll
        for (int j = 0; j < kMaxPerThread; ++j) {
          if (on[j]) {
            const float v = cq[d][j] * (g * rd[i0[j]] + f * rd[i1[j]]) + kq[d][j];
            wr[ys[j]] = v;
            if (emit) out[out_off + ys[j]] = v;
          }
        }
        const int tn = t + kDepth;
        if (tn < total) {
          const size_t off = static_cast<size_t>(tn % n_cols) * col_stride + line_off;
#pragma unroll
          for (int j = 0; j < kMaxPerThread; ++j) {
            if (on[j]) {
              cq[d][j] = coeff[off + ys[j]];
              kq[d][j] = cnst[off + ys[j]];
            }
          }
        }
        __syncthreads();
        float* tmp = rd;
        rd = wr;
        wr = tmp;
      }
    }
  }
}

ffi::Error MarchImpl(cudaStream_t stream, ffi::Buffer<ffi::F32> coeff,
                     ffi::Buffer<ffi::F32> cnst, ffi::Buffer<ffi::F32> f_rows,
                     ffi::ResultBuffer<ffi::F32> out, int64_t s_base,
                     int64_t n_sweeps) {
  const auto dims = coeff.dimensions();
  if (dims.size() != 3) {
    return ffi::Error::InvalidArgument("vrt_march: coeff must be (N, B, M)");
  }
  const int64_t n_cols = dims[0], n_lines = dims[1], m = dims[2];
  if (cnst.element_count() != coeff.element_count() ||
      f_rows.element_count() != static_cast<size_t>(n_lines)) {
    return ffi::Error::InvalidArgument(
        "vrt_march: const must match coeff and f must hold one value per line");
  }
  if (m > 1024 * kMaxPerThread) {
    return ffi::Error::InvalidArgument("vrt_march: line longer than 4096");
  }
  if (n_cols == 0 || n_lines == 0 || m == 0) return ffi::Error::Success();
  const int threads =
      static_cast<int>(m >= 1024 ? 1024 : ((m + 31) / 32) * 32);
  const size_t smem = 2 * static_cast<size_t>(m) * sizeof(float);
  march_kernel<<<static_cast<unsigned>(n_lines), threads, smem, stream>>>(
      coeff.typed_data(), cnst.typed_data(), f_rows.typed_data(),
      out->typed_data(), static_cast<int>(n_cols), static_cast<int>(n_lines),
      static_cast<int>(m), static_cast<int>(s_base),
      static_cast<int>(n_sweeps));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    return ffi::Error::Internal(std::string("vrt_march: ") +
                                cudaGetErrorString(err));
  }
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(VrtMarch, MarchImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Ret<ffi::Buffer<ffi::F32>>()
                                  .Attr<int64_t>("s_base")
                                  .Attr<int64_t>("n_sweeps"));
