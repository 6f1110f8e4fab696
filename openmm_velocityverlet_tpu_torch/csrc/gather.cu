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
//   * B7: no staging.  The (8, C) block (32 KB at C = 1024) is read through
//     the read-only path (__ldg), where it stays in L1 and L2.  One thread
//     an output column: one index load, then the 8 rows' table reads issued
//     together (the row count a template constant for the tool's 8) and 8
//     stores, neighbouring threads on neighbouring addresses in each row;
//     one block of 256 threads for each 256 columns.  The first design
//     staged the whole 32 KB table in shared memory in each of up to 264
//     blocks behind a __syncthreads(): 8.4 MB of L2 reads for 4.75 MB of
//     useful traffic, 26% of the bound.  That design and one of four
//     columns a thread (16-byte index loads and stores, one wave of the
//     card) both measure slower than this on the H100
//     (tools/lane_gather_designs.py times the three side by side).
//   * B8: the block's first 128 columns (4 KB) are staged in shared memory
//     by each of at most 264 blocks, which walk the output columns with a
//     grid stride; a thread reads an index once and writes its 8 values,
//     neighbouring threads on neighbouring addresses in each of the 8 output
//     rows.
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

// B7: out[r, j] = blk[r, idx[j]], one output column a thread.  Rows > 0
// fixes the row count at compile time (the tool's 8), so that the reads of
// all rows are issued together; Rows = 0 takes n_rows.
template <int Rows>
__global__ void __launch_bounds__(kThreads)
gather_lanes_kernel(const float* __restrict__ blk, const int* __restrict__ idx,
                    float* __restrict__ out, int n_rows, int n_cols, int m) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= m) return;
  const int s = __ldg(idx + j);
  const bool ok = s >= 0 && s < n_cols;
  const int rows = Rows > 0 ? Rows : n_rows;
#pragma unroll
  for (int r = 0; r < rows; ++r)
    out[(size_t)r * m + j] = ok ? __ldg(blk + (size_t)r * n_cols + s) : 0.f;
}

// B8: out[r, j] = blk[r, idx[j] mod 128].  Each block stages the block's
// first 128 columns once and walks the output columns with a grid stride.
__global__ void __launch_bounds__(kThreads)
gather_lanes_mod128_kernel(const float* __restrict__ blk,
                           const int* __restrict__ idx,
                           float* __restrict__ out, int n_rows, int n_cols,
                           int m) {
  extern __shared__ float s_blk[];
  const int w = 128;  // staged width
  for (int k = threadIdx.x; k < n_rows * w; k += kThreads) {
    const int r = k / w;
    s_blk[k] = blk[(size_t)r * n_cols + (k - r * w)];
  }
  __syncthreads();
  for (int j = blockIdx.x * kThreads + threadIdx.x; j < m;
       j += gridDim.x * kThreads) {
    int s = idx[j];
    s = ((s % 128) + 128) % 128;
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

// B7 (mod128 = 0) and B8 (mod128 = 1).  B8's staged 128 columns must fit
// in shared memory.
int gather_lanes_launch(const float* blk, const int* idx, float* out,
                        int n_rows, int n_cols, int m, int mod128,
                        void* stream) {
  const size_t smem = (size_t)n_rows * 128 * sizeof(float);
  if (n_rows < 1 || n_cols < 1 || m < 0 ||
      (mod128 && (n_cols < 128 || smem > 227 * 1024)))
    return (int)cudaErrorInvalidValue;
  if (m == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (mod128) {
    // two blocks an SM at most: each block stages the table once
    const int need = (m + kThreads - 1) / kThreads;
    const int blocks = need < 264 ? need : 264;
    err = cudaFuncSetAttribute(gather_lanes_mod128_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    gather_lanes_mod128_kernel<<<blocks, kThreads, smem, st>>>(
        blk, idx, out, n_rows, n_cols, m);
    return (int)cudaGetLastError();
  }
  const int blocks = (m + kThreads - 1) / kThreads;
  if (n_rows == 8)
    gather_lanes_kernel<8><<<blocks, kThreads, 0, st>>>(blk, idx, out, n_rows,
                                                       n_cols, m);
  else
    gather_lanes_kernel<0><<<blocks, kThreads, 0, st>>>(blk, idx, out, n_rows,
                                                       n_cols, m);
  return (int)cudaGetLastError();
}

const char* gather_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
