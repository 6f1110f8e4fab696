// Kernels B6, B7 and B8: the gather-throughput kernels of the gather tool,
// for Hopper.
//
// Replace openmm_velocityverlet_tpu's tools/exp_gather_kernel.py:
//   * B6 variant_sublane:    out[i, :] = blk[idx[i], :], blk (R, W) f32,
//     idx (M,) i32, out (M, W) f32 (the tool: R = 1024, W = 128,
//     M = 131,072);
//   * B7 variant_lane:       out[r, j] = blk[r, idx[j]], blk (8, C) f32,
//     idx (M,) i32, out (8, M) f32 (C = 1024);
//   * B8 variant_lane_tiled: out[r, j] = blk[r, idx[j] mod 128], the same
//     shapes (the take_along_axis over the first 128 lanes; mod is the
//     floor modulo of jnp, non-negative for any index).
// The TPU kernels hold the whole block in VMEM and gather from it with
// jnp.take.  Here:
//   * B6: one warp per output row, 32 lanes x float4 = 128 floats: the row
//     of blk is read as four 16-byte words a lane (blk, 512 KB at the tool's
//     size, stays in L2) and the output row is written as one coalesced
//     512-byte store.  Widths that are not a multiple of 4 take a scalar
//     loop.
//   * B7/B8: the (8, C) block (32 KB at C = 1024; B8 only its first 128
//     columns) is staged in shared memory by each of at most 264 blocks,
//     which walk the output columns with a grid stride; a thread reads an
//     index once and writes its 8 values, neighbouring threads on
//     neighbouring addresses in each of the 8 output rows.
// An index outside the block's range writes zeros instead of reading out of
// bounds (the plain versions raise); the tool draws every index in range.
//
// Bound: bytes.  Each kernel reads idx and the part of the block that idx
// names once and writes out once: B6 68.2 MB (0.020 ms at 3.35 TB/s), B7
// 4.75 MB and B8, which reads only the block's first 128 columns, 4.72 MB
// (0.0014 ms each).  No arithmetic beyond the address computation.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const float* __restrict__ blk, const int* __restrict__ idx,
                   float* __restrict__ out, int n_src, int width, int m) {
  const int warps = kThreads / 32;
  const int row = blockIdx.x * warps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= m) return;
  const int s = idx[row];
  const bool ok = s >= 0 && s < n_src;
  const float* src = blk + (size_t)(ok ? s : 0) * width;
  float* dst = out + (size_t)row * width;
  if ((width & 3) == 0) {
    const float4* src4 = reinterpret_cast<const float4*>(src);
    float4* dst4 = reinterpret_cast<float4*>(dst);
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k = lane; k < (width >> 2); k += 32)
      dst4[k] = ok ? __ldg(src4 + k) : zero;
  } else {
    for (int k = lane; k < width; k += 32) dst[k] = ok ? __ldg(src + k) : 0.f;
  }
}

// out[r, j] = blk[r, idx[j]] (Mod128 false) or blk[r, idx[j] mod 128].
// Each block stages the block (its first 128 columns with Mod128) once and
// walks the output columns with a grid stride.
template <bool Mod128>
__global__ void __launch_bounds__(kThreads)
gather_lanes_kernel(const float* __restrict__ blk, const int* __restrict__ idx,
                    float* __restrict__ out, int n_rows, int n_cols, int m) {
  extern __shared__ float s_blk[];
  const int w = Mod128 ? 128 : n_cols;  // staged width
  for (int k = threadIdx.x; k < n_rows * w; k += kThreads) {
    const int r = k / w;
    s_blk[k] = blk[(size_t)r * n_cols + (k - r * w)];
  }
  __syncthreads();
  for (int j = blockIdx.x * kThreads + threadIdx.x; j < m;
       j += gridDim.x * kThreads) {
    int s = idx[j];
    if (Mod128) s = ((s % 128) + 128) % 128;
    const bool ok = s >= 0 && s < w;
    for (int r = 0; r < n_rows; ++r)
      out[(size_t)r * m + j] = ok ? s_blk[r * w + s] : 0.f;
  }
}

}  // namespace

extern "C" {

// B6.  Returns cudaGetLastError() of the launch (0 on success).
int gather_rows_launch(const float* blk, const int* idx, float* out,
                       int n_src, int width, int m, void* stream) {
  if (n_src < 1 || width < 1 || m < 0) return (int)cudaErrorInvalidValue;
  if (m == 0) return 0;
  const int warps = kThreads / 32;
  gather_rows_kernel<<<(m + warps - 1) / warps, kThreads, 0,
                       (cudaStream_t)stream>>>(blk, idx, out, n_src, width,
                                               m);
  return (int)cudaGetLastError();
}

// B7 (mod128 = 0) and B8 (mod128 = 1).  The staged block (n_rows x n_cols,
// or n_rows x 128 with mod128) must fit in shared memory.
int gather_lanes_launch(const float* blk, const int* idx, float* out,
                        int n_rows, int n_cols, int m, int mod128,
                        void* stream) {
  const size_t smem =
      (size_t)n_rows * (mod128 ? 128 : n_cols) * sizeof(float);
  if (n_rows < 1 || n_cols < 1 || m < 0 || smem > 227 * 1024 ||
      (mod128 && n_cols < 128))
    return (int)cudaErrorInvalidValue;
  if (m == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  // two blocks an SM at most: each block stages the table once
  const int need = (m + kThreads - 1) / kThreads;
  const int blocks = need < 264 ? need : 264;
  cudaError_t err;
  if (mod128) {
    err = cudaFuncSetAttribute(gather_lanes_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    gather_lanes_kernel<true><<<blocks, kThreads, smem, st>>>(
        blk, idx, out, n_rows, n_cols, m);
  } else {
    err = cudaFuncSetAttribute(gather_lanes_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    gather_lanes_kernel<false><<<blocks, kThreads, smem, st>>>(
        blk, idx, out, n_rows, n_cols, m);
  }
  return (int)cudaGetLastError();
}

const char* gather_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
