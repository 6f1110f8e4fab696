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
// kernel adds the chunks for each k in ascending order.
//
// B5 uses what the list is: the integer lattice nx in [-kmx, kmx], ny in
// [-kmy, kmy], nz in [0, kmz] in C order with nz fastest, less the
// non-canonical half of the nz = 0 plane (ops/ewald_fused.py:
// _half_space_modes).  So e^{i k.r} = ex[nx] ey[ny] ez[nz], and an atom needs
// a few dozen sincosf, not one a mode.  One thread an atom, 128 atoms a
// block, and a split of the nx range a block (grid.y), so the card is filled.
// The thread builds its y and z tables with one direct sincosf of k_n * y
// each (build_phase_table; k_n = (2 pi n) / L rounded exactly as the list's
// kvec; no running product, so no error grows along a table) into shared
// memory laid out [n][thread], which is free of bank conflicts, and takes the
// x phase of each of its block's few nx on the fly.  For each nx the block
// stages that slab's (a_k, b_k) densely as [nz][ny] (zero where the list has
// no mode), read as 16-byte broadcasts.  The thread then takes four ny
// columns at a time: exy = ex[nx] ey[ny] once a column, and along nz
// e = exy ez[nz] (4 operations), g = a c - b s (2), G += g, Gz += g nz (2);
// after the column fx += kx G, fy += ky G, and fz = kz(1) Gz at the end.  The
// ez read is shared by those columns, so the loop is bound by the FP32 pipes
// and not by shared-memory reads.  A second kernel adds the splits for each
// atom in ascending order.  No atomics: both kernels are bitwise
// deterministic from run to run.
//
// Bound: operations.  B4 takes one full-range sincosf for each of its N K
// phases (the phase reaches 2 pi kmax ~ 126 rad at kmax 20, where the fast
// __sincosf intrinsic loses its accuracy, so it is not used) plus a handful
// of FMAs.  B5 takes 8 FP32 operations a phase and no special function; the
// bytes moved are O(N + K) plus the partials.  The factorised phase is the
// product of three factors whose arguments are each rounded once, where the
// direct form rounds the three-term sum k.r at up to 126 rad: it is no less
// exact than the plain version.
//
// Tensor cores: the nz sum is a small (atoms x nz) . (nz x columns) product,
// but TF32 keeps three decimal digits and the reciprocal sum cancels to
// about 1e-6 of its terms (ops/ewald.py says why it needs float32), so both
// kernels stay on the FP32 pipes.

#include <cuda_runtime.h>

namespace {

constexpr int kAtomChunk = 256;   // B4: atoms per block (= threads per block)
constexpr int kKThreads = 256;    // B4: k vectors per block
constexpr int kForceThreads = 128;  // B5: atoms per block
constexpr int kNyBlock = 4;       // B5: ny columns a thread takes at a time
constexpr int kMaxSmem = 227 * 1024;
constexpr float kTwoPi = 6.2831855f;  // float32(2 pi), as the k list's

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

// The k values of one axis, n = 0 .. km: (2 pi n) / L in the list's own
// rounding (ops/ewald_fused.py:_prep), written by the block's first threads.
__device__ __forceinline__ void stage_axis_k(float* s_k, int km, float L) {
  for (int n = threadIdx.x; n <= km; n += blockDim.x)
    s_k[n] = (kTwoPi * (float)n) / L;
}

// One axis of a thread's phase table: (cos, sin)(k_n * x), n = 0 .. km, one
// direct sincosf each, laid out tab[n * stride + tid].  Negative n is the
// conjugate.
__device__ __forceinline__ void build_phase_table(float x, const float* s_k,
                                                  int km, float2* tab,
                                                  int tid, int stride) {
  for (int n = 0; n <= km; ++n) {
    float sn, cs;
    sincosf(s_k[n] * x, &sn, &cs);
    tab[n * stride + tid] = make_float2(cs, sn);
  }
}

// NB consecutive ny columns (from index iy0 = ny + kmy, a multiple of NB) of
// one nx slab.  The slab is laid out [nz][ny] with an even row length nyp, so
// the (a, b) of four neighbouring columns at one nz are two 16-byte
// broadcast reads.  gz sums t * nz; the caller scales it by kz(1).
template <int NB>
__device__ __forceinline__ void ny_columns(
    const float2* taby, const float2* tabz, const float2* slab,
    const float* s_ky, float2 ex, int kmy, int nzs, int nyp, int iy0, int tid,
    float& gx, float& fy, float& gzsum) {
  static_assert(NB == 1 || NB == 4, "ny_columns: 1 or 4 columns");
  float c[NB], s[NB], g[NB], gz[NB];
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    const int ny = iy0 + b - kmy;
    float2 ey = taby[(ny < 0 ? -ny : ny) * kForceThreads + tid];
    if (ny < 0) ey.y = -ey.y;
    c[b] = ex.x * ey.x - ex.y * ey.y;
    s[b] = ex.x * ey.y + ex.y * ey.x;
    g[b] = 0.f;
    gz[b] = 0.f;
  }
  const float2* col = slab + iy0;
  float nzf = 0.f;
#pragma unroll 3
  for (int nz = 0; nz < nzs; ++nz, col += nyp, nzf += 1.0f) {
    const float2 ez = tabz[nz * kForceThreads + tid];
    float2 ab[NB];
    if constexpr (NB == 4) {
      const float4 lo = reinterpret_cast<const float4*>(col)[0];
      const float4 hi = reinterpret_cast<const float4*>(col)[1];
      ab[0] = make_float2(lo.x, lo.y);
      ab[1] = make_float2(lo.z, lo.w);
      ab[2] = make_float2(hi.x, hi.y);
      ab[3] = make_float2(hi.z, hi.w);
    } else {
      ab[0] = col[0];
    }
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const float c3 = c[b] * ez.x - s[b] * ez.y;
      const float s3 = c[b] * ez.y + s[b] * ez.x;
      const float t = ab[b].x * c3 - ab[b].y * s3;  // dE/dtheta / q
      g[b] += t;
      gz[b] += t * nzf;
    }
  }
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    const int ny = iy0 + b - kmy;
    const float ky = ny < 0 ? -s_ky[-ny] : s_ky[ny];
    gx += g[b];
    fy += ky * g[b];
    gzsum += gz[b];
  }
}

// Dynamic shared memory: the y and z phase tables float2[kmy + kmz + 2][128]
// (the x phase of a block's few nx is taken on the fly), the slab
// float2[kmz + 1][2 kmy + 2], then kx, ky, kz.
__global__ void __launch_bounds__(kForceThreads)
force_kernel(const float* pos, const float* q, const float* ab,
             const float* box, const int* col_off, int kmx, int kmy, int kmz,
             int nx_per, int n_pad, int kp, float* part) {
  extern __shared__ __align__(16) float2 smem2[];
  const int n_tab = kmy + kmz + 2;
  const int nys = 2 * kmy + 1, nzs = kmz + 1, nyp = nys + 1;
  float2* taby = smem2;
  float2* tabz = taby + (kmy + 1) * kForceThreads;
  float2* slab = taby + n_tab * kForceThreads;
  float* s_kx = reinterpret_cast<float*>(slab + nyp * nzs);
  float* s_ky = s_kx + kmx + 1;
  float* s_kz = s_ky + kmy + 1;
  const int tid = threadIdx.x;
  const int i = blockIdx.x * kForceThreads + tid;
  float px = 0.f, py = 0.f, pz = 0.f, qi = 0.f;
  if (i < n_pad) {
    px = pos[3 * i];
    py = pos[3 * i + 1];
    pz = pos[3 * i + 2];
    qi = q[i];
  }
  stage_axis_k(s_kx, kmx, box[0]);
  stage_axis_k(s_ky, kmy, box[1]);
  stage_axis_k(s_kz, kmz, box[2]);
  __syncthreads();
  build_phase_table(py, s_ky, kmy, taby, tid, kForceThreads);
  build_phase_table(pz, s_kz, kmz, tabz, tid, kForceThreads);

  const int ix0 = blockIdx.y * nx_per;
  const int ix1 = min(2 * kmx + 1, ix0 + nx_per);
  float fx = 0.f, fy = 0.f, gz = 0.f;
  for (int ix = ix0; ix < ix1; ++ix) {
    const int nx = ix - kmx;
    __syncthreads();  // the previous slab is read out
    for (int t = tid; t < nys * nzs; t += kForceThreads) {
      const int iy = t / nzs, nz = t - iy * nzs;
      const int o0 = col_off[ix * nys + iy], o1 = col_off[ix * nys + iy + 1];
      const int k = o0 + nz - (nzs - (o1 - o0));  // columns end at nz = kmz
      slab[nz * nyp + iy] = k >= o0 ? make_float2(ab[k], ab[kp + k])
                                    : make_float2(0.f, 0.f);
    }
    __syncthreads();
    const float kx = nx < 0 ? -s_kx[-nx] : s_kx[nx];
    float2 ex;
    sincosf(kx * px, &ex.y, &ex.x);
    float gx = 0.f;
    int iy = 0;
    for (; iy + kNyBlock <= nys; iy += kNyBlock)
      ny_columns<kNyBlock>(taby, tabz, slab, s_ky, ex, kmy, nzs, nyp, iy, tid,
                           gx, fy, gz);
    for (; iy < nys; ++iy)
      ny_columns<1>(taby, tabz, slab, s_ky, ex, kmy, nzs, nyp, iy, tid, gx, fy,
                    gz);
    fx += kx * gx;
  }
  if (i < n_pad) {
    float* dst = part + (size_t)blockIdx.y * 3 * n_pad;
    dst[i] = qi * fx;
    dst[n_pad + i] = qi * fy;
    // kz(n) = n kz(1) to one rounding of the list's (2 pi n) / L
    dst[2 * n_pad + i] = qi * (kmz > 0 ? s_kz[1] : 0.f) * gz;
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

// B5's dynamic shared memory for kmax (see force_kernel).
static size_t force_smem(int kmx, int kmy, int kmz) {
  return (size_t)(kmy + kmz + 2) * kForceThreads * sizeof(float2) +
         (size_t)(2 * kmy + 2) * (kmz + 1) * sizeof(float2) +
         (size_t)(kmx + kmy + kmz + 3) * sizeof(float);
}

// Lets force_kernel ask for `smem` bytes of dynamic shared memory.
static cudaError_t force_allow_smem(size_t smem) {
  static size_t raised = 48 * 1024;  // the most a block may ask so far
  if (smem <= raised) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      force_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) raised = smem;
  return err;
}

// B5: nx values a block takes.  Blocks run in waves of as many as the card
// holds at once; a launch of 2.04 waves takes as long as one of 3.  So the
// split is the one with the least (waves x work of a block), a block's work
// being its nx count plus about half an nx for its tables.  It depends only
// on the shapes and the card, so the summation order is fixed for a run.
static int force_nx_per(int kmx, int kmy, int kmz, int n_pad) {
  static int key[4] = {-1, -1, -1, -1}, cached = 1;
  if (key[0] == kmx && key[1] == kmy && key[2] == kmz && key[3] == n_pad)
    return cached;
  int dev = 0, sms = 1, per_sm = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (force_smem(kmx, kmy, kmz) <= (size_t)kMaxSmem)
    force_allow_smem(force_smem(kmx, kmy, kmz));
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, force_kernel, kForceThreads, force_smem(kmx, kmy, kmz));
  const long long slots = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const long long atom_blocks = (n_pad + kForceThreads - 1) / kForceThreads;
  const int nxs = 2 * kmx + 1;
  int best = 1;
  double best_cost = 1e300;
  for (int per = 1; per <= nxs; ++per) {
    const long long blocks = atom_blocks * ((nxs + per - 1) / per);
    const double cost = (double)((blocks + slots - 1) / slots) * (per + 0.5);
    if (cost < best_cost) {
      best_cost = cost;
      best = per;
    }
  }
  key[0] = kmx;
  key[1] = kmy;
  key[2] = kmz;
  key[3] = n_pad;
  cached = best;
  return best;
}

// B5: the number of nx splits (grid.y; the first dimension of `part`).
int ewald_force_splits(int kmx, int kmy, int kmz, int n_pad) {
  const int per = force_nx_per(kmx, kmy, kmz, n_pad);
  return (2 * kmx + 1 + per - 1) / per;
}

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

// B5: forces (n_pad, 3) from ab (2, kp) = (a_k, b_k) over the half-space
// list of kmax = (kmx, kmy, kmz); box (3,) on the device; col_off
// ((2 kmx + 1)(2 kmy + 1) + 1,) the list offset of each (nx, ny) column;
// part is (ewald_force_splits(kmx, kmy, kmz, n_pad), 3, n_pad) scratch.
// Returns cudaGetLastError().
int ewald_force_launch(const float* pos, const float* q, const float* ab,
                       const float* box, const int* col_off, int kmx, int kmy,
                       int kmz, int n_pad, int kp, float* part, float* f,
                       void* stream) {
  if (n_pad <= 0 || kp <= 0 || kmx < 0 || kmy < 0 || kmz < 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = force_smem(kmx, kmy, kmz);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = force_allow_smem(smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((n_pad + kForceThreads - 1) / kForceThreads,
                  ewald_force_splits(kmx, kmy, kmz, n_pad));
  force_kernel<<<grid, kForceThreads, smem, st>>>(
      pos, q, ab, box, col_off, kmx, kmy, kmz,
      force_nx_per(kmx, kmy, kmz, n_pad), n_pad, kp, part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  force_reduce_kernel<<<(n_pad + 255) / 256, 256, 0, st>>>(
      part, ewald_force_splits(kmx, kmy, kmz, n_pad), n_pad, f);
  return (int)cudaGetLastError();
}

const char* ewald_fused_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
