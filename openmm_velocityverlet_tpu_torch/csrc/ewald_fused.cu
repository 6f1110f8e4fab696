// Kernels B4 and B5: the fused exact-k Ewald reciprocal sum, for Hopper.
//
// B4 replaces openmm_velocityverlet_tpu/ops/ewald_pallas.py:_structure_kernel
// (launched by _structure_factor): over the flattened half-space list of K
// wave vectors k (kvec, (3, kp)), the structure factor
//     S_re(k) = sum_i q_i cos(k . r_i),   S_im(k) = sum_i q_i sin(k . r_i).
// B5 replaces _force_kernel (launched by _forces): with (a_k, b_k) =
// 2 c0 w_k (S_im, S_re), the per-atom force
//     F_i = -q_i sum_k (a_k cos(k . r_i) - b_k sin(k . r_i)) k.
// Neither writes anything of size (N, K): the phases are recomputed in
// registers, as the TPU kernels recompute them in VMEM.
//
// Design.  The TPU grid runs in order and accumulates S over the atom-tile
// axis (B4) or F over the k-tile axis (B5) in one resident output block.
// Here B4 gives each thread one k and each block a chunk of 256 atoms staged
// in shared memory; the block writes per-chunk partial sums, and a second
// kernel adds the chunks for each k in ascending order.  B5 gives each thread
// one atom and each block a split of 2048 k vectors staged in shared memory
// in tiles of 512; a second kernel adds the splits for each atom in ascending
// order.  No atomics: both are bitwise deterministic from run to run.
//
// Bound: operations.  Each of the 2 N K phases per pass takes one full-range
// sincosf (the phase reaches 2 pi kmax ~ 126 rad at kmax 20, where the fast
// __sincosf intrinsic loses its accuracy, so it is not used) plus a handful
// of FMAs; the bytes moved are O(N + K) plus the partials.

#include <cuda_runtime.h>

namespace {

constexpr int kAtomChunk = 256;   // B4: atoms per block (= threads per block)
constexpr int kKThreads = 256;    // B4: k vectors per block
constexpr int kForceThreads = 128;  // B5: atoms per block
constexpr int kKSplit = 2048;     // B5: k vectors per block
constexpr int kKTile = 512;       // B5: k vectors staged at a time

__global__ void __launch_bounds__(kKThreads)
structure_kernel(const float* pos, const float* q, const float* kvec,
                 int n_pad, int kp, float* part) {
  __shared__ float sx[kAtomChunk], sy[kAtomChunk], sz[kAtomChunk],
      sq[kAtomChunk];
  const int k = blockIdx.x * kKThreads + threadIdx.x;
  const int a0 = blockIdx.y * kAtomChunk;
  const int na = min(kAtomChunk, n_pad - a0);
  if (threadIdx.x < na) {
    const int a = a0 + threadIdx.x;
    sx[threadIdx.x] = pos[3 * a];
    sy[threadIdx.x] = pos[3 * a + 1];
    sz[threadIdx.x] = pos[3 * a + 2];
    sq[threadIdx.x] = q[a];
  }
  __syncthreads();
  if (k >= kp) return;
  const float kx = kvec[k], ky = kvec[kp + k], kz = kvec[2 * kp + k];
  float re = 0.f, im = 0.f;
  for (int a = 0; a < na; ++a) {
    const float th = sx[a] * kx + sy[a] * ky + sz[a] * kz;
    float s, c;
    sincosf(th, &s, &c);
    re += sq[a] * c;
    im += sq[a] * s;
  }
  float* dst = part + (size_t)blockIdx.y * 2 * kp;
  dst[k] = re;
  dst[kp + k] = im;
}

// S(k) = sum of the atom-chunk partials in ascending chunk order.
__global__ void structure_reduce_kernel(const float* part, int n_chunks,
                                        int kp, float* s_re, float* s_im) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= kp) return;
  float re = 0.f, im = 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    re += part[(size_t)c * 2 * kp + k];
    im += part[(size_t)c * 2 * kp + kp + k];
  }
  s_re[k] = re;
  s_im[k] = im;
}

__global__ void __launch_bounds__(kForceThreads)
force_kernel(const float* pos, const float* q, const float* kvec,
             const float* ab, int n_pad, int kp, float* part) {
  __shared__ float skx[kKTile], sky[kKTile], skz[kKTile], sa[kKTile],
      sb[kKTile];
  const int i = blockIdx.x * kForceThreads + threadIdx.x;
  const int k0 = blockIdx.y * kKSplit;
  const int k1 = min(kp, k0 + kKSplit);
  float px = 0.f, py = 0.f, pz = 0.f, qi = 0.f;
  if (i < n_pad) {
    px = pos[3 * i];
    py = pos[3 * i + 1];
    pz = pos[3 * i + 2];
    qi = q[i];
  }
  float fx = 0.f, fy = 0.f, fz = 0.f;
  for (int kc = k0; kc < k1; kc += kKTile) {
    const int nk = min(kKTile, k1 - kc);
    __syncthreads();
    for (int t = threadIdx.x; t < nk; t += kForceThreads) {
      skx[t] = kvec[kc + t];
      sky[t] = kvec[kp + kc + t];
      skz[t] = kvec[2 * kp + kc + t];
      sa[t] = ab[kc + t];
      sb[t] = ab[kp + kc + t];
    }
    __syncthreads();
    for (int t = 0; t < nk; ++t) {
      const float th = px * skx[t] + py * sky[t] + pz * skz[t];
      float s, c;
      sincosf(th, &s, &c);
      const float g = qi * (sa[t] * c - sb[t] * s);  // dE/dtheta
      fx += g * skx[t];
      fy += g * sky[t];
      fz += g * skz[t];
    }
  }
  if (i < n_pad) {
    float* dst = part + (size_t)blockIdx.y * 3 * n_pad;
    dst[i] = fx;
    dst[n_pad + i] = fy;
    dst[2 * n_pad + i] = fz;
  }
}

// F_i = -(sum of the k-split partials in ascending split order), (n_pad, 3).
__global__ void force_reduce_kernel(const float* part, int n_splits,
                                    int n_pad, float* f) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_pad) return;
  float acc[3] = {0.f, 0.f, 0.f};
  for (int s = 0; s < n_splits; ++s)
    for (int c = 0; c < 3; ++c)
      acc[c] += part[((size_t)s * 3 + c) * n_pad + i];
  for (int c = 0; c < 3; ++c) f[3 * i + c] = -acc[c];
}

}  // namespace

extern "C" {

int ewald_structure_chunks(int n_pad) {
  return (n_pad + kAtomChunk - 1) / kAtomChunk;
}

int ewald_force_splits(int kp) { return (kp + kKSplit - 1) / kKSplit; }

// B4: S_re, S_im (kp,) of pos (n_pad, 3), q (n_pad,), kvec (3, kp); part is
// (ewald_structure_chunks(n_pad), 2, kp) scratch.  Returns cudaGetLastError().
int ewald_structure_launch(const float* pos, const float* q,
                           const float* kvec, int n_pad, int kp, float* part,
                           float* s_re, float* s_im, void* stream) {
  if (n_pad <= 0 || kp <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((kp + kKThreads - 1) / kKThreads,
                  ewald_structure_chunks(n_pad));
  structure_kernel<<<grid, kKThreads, 0, st>>>(pos, q, kvec, n_pad, kp, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  structure_reduce_kernel<<<(kp + 255) / 256, 256, 0, st>>>(
      part, ewald_structure_chunks(n_pad), kp, s_re, s_im);
  return (int)cudaGetLastError();
}

// B5: forces (n_pad, 3) from ab (2, kp) = (a_k, b_k); part is
// (ewald_force_splits(kp), 3, n_pad) scratch.  Returns cudaGetLastError().
int ewald_force_launch(const float* pos, const float* q, const float* kvec,
                       const float* ab, int n_pad, int kp, float* part,
                       float* f, void* stream) {
  if (n_pad <= 0 || kp <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((n_pad + kForceThreads - 1) / kForceThreads,
                  ewald_force_splits(kp));
  force_kernel<<<grid, kForceThreads, 0, st>>>(pos, q, kvec, ab, n_pad, kp,
                                               part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  force_reduce_kernel<<<(n_pad + 255) / 256, 256, 0, st>>>(
      part, ewald_force_splits(kp), n_pad, f);
  return (int)cudaGetLastError();
}

const char* ewald_fused_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
