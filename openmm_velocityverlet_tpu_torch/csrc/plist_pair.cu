// Kernel B1: the AABB-culled tile-pair-list nonbonded sweep, for Hopper.
//
// Replaces openmm_velocityverlet_tpu/ops/pallas_pair.py:_plist_kernel
// (launched by _run_plist).  Computes, for every active entry of the packed
// pair list (word = row_tile<<17 | col_tile<<3 | flags; bit0 active, bit1
// has-exclusions), the LJ + Ewald direct-space + exclusion-correction
// interactions of a (ts x ts) tile pair in the sorted layout:
//   * minimum image per pair, or on "nowrap" axes the row tile's
//     first-atom frame (row and column wrapped once each, then subtracted);
//   * exclusions by the one-sided 31-bit offset mask on original indices;
//   * LJ (a/r^6)^2 - b/r^6 (+ the quintic switch), coefficients by direct
//     lookup: a_ij = ab2[A-row of i][type_j] (times the group-allowed entry
//     of the G block when present) -- the index form of the TPU kernel's
//     one-hot MXU dot, exact in float32;
//   * Coulomb: force-only form qq (min(1/r^3, 1/0.045^3) + P(r^2)) with the
//     Chebyshev P passed in; energy form with the A&S erfc and half weight
//     on diagonal tiles.  Excluded pairs get -qq erf(beta r)/r.
// Outputs keep the JAX layout: rows (n_tiles*ts, 8) = fx,fy,fz,e_lj,
// e_coul,e_corr,0,0 and colacc (8, n_pad) with the Newton reaction of
// off-diagonal tiles in rows 0..2.
//
// Design.  The TPU grid is sequential, so the Pallas kernel accumulates rows
// in place across consecutive entries of a row tile; on the GPU blocks run in
// parallel, so each block (one active entry, one thread per row atom) writes
// its row and column partial sums to a per-entry buffer, and a second kernel
// reduces them per tile in ascending entry order.  Inside a block, warp w
// visits the ts/32 column chunks in the order (w + k) mod (ts/32); lane l
// takes column (l + s) & 31 of the chunk at step s, so the column force
// accumulator rotates one lane per step (__shfl_sync) and meets every row of
// the warp.  After each chunk phase (a __syncthreads) every warp adds its
// chunk partial to the block's shared column sums; in a phase the warps hold
// distinct chunks, so no atomics are needed.  Every sum therefore runs in a
// fixed order: the result is bitwise deterministic from run to run (checked
// on the card by chip_smoke.py and tests/test_torch_kernels.py).
//
// Bound: arithmetic.  A tile pair reads 8 words per column atom once into
// shared memory and then does ~40-60 FP32 operations per pair for ts^2 pairs;
// device memory traffic (positions, partials) is small next to that.  The
// exclusion integer ops run only on entries whose has-exclusions flag is set.
//
// Rounding: positions wrap with rintf (round half to even, as jnp.round);
// 1/sqrt is rsqrtf (about 2 ulp from jax.lax.rsqrt), and nvcc contracts
// multiply-adds into FMAs, so the kernel agrees with its plain torch
// version to float32 rounding, not bitwise.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxTs = 384;
constexpr int kNCoef = 11;
constexpr float kOne4PiEps0 = 138.935456f;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const int* plist;
  const float* pos;     // (n_pad, 3) sorted
  const float* q;       // (n_pad,)
  const float* ab2;     // (stack * n_pad, K) tile-major stacked LJ rows
  const int* ctype;     // (n_pad,) LJ type, -1 for pad atoms
  const int* cgroup;    // (n_pad,) interaction group
  const int* bits;      // (n_pad,) exclusion masks
  const int* oid;       // (n_pad,) original atom indices
  const float* box;     // (3,)
  float* prow;          // (cap, 6, ts) per-entry row partials
  float* pcol;          // (cap, 3, ts) per-entry column partials
  int ts, K, t_dim, stack, nowrap;
  float beta, rc2, r_cutoff, r_switch, cap3, gauss_pref;
  float pc[kNCoef];
};

__device__ __forceinline__ float wrap_frame(float a, float c0, float L,
                                            float iL) {
  return a - L * rintf((a - c0) * iL);
}

template <bool WantEnergy>
__global__ void __launch_bounds__(kMaxTs)
plist_pair_kernel(Params p) {
  const int e = blockIdx.x;
  const int word = p.plist[e];
  if ((word & 1) == 0) return;  // pad entry: uniform for the block
  const int ti = word >> 17;
  const int tj = (word >> 3) & 0x3FFF;
  const bool test_excl = WantEnergy || ((word & 2) != 0);
  const bool diag = ti == tj;
  const int ts = p.ts;
  const int r = threadIdx.x;
  const int lane = r & 31;
  const int warp = r >> 5;
  const int nw = ts >> 5;

  __shared__ float s_x[kMaxTs], s_y[kMaxTs], s_z[kMaxTs], s_q[kMaxTs];
  __shared__ int s_t[kMaxTs], s_g[kMaxTs], s_b[kMaxTs], s_o[kMaxTs];
  __shared__ float s_f[3][kMaxTs];

  const float bx = p.box[0], by = p.box[1], bz = p.box[2];
  const float ibx = 1.0f / bx, iby = 1.0f / by, ibz = 1.0f / bz;
  const bool nwx = p.nowrap & 1, nwy = p.nowrap & 2, nwz = p.nowrap & 4;
  const int row = ti * ts + r;
  const int r0 = ti * ts;  // first atom of the row tile: the nowrap frame
  const float c0x = p.pos[3 * r0], c0y = p.pos[3 * r0 + 1],
              c0z = p.pos[3 * r0 + 2];

  // stage the column tile (positions pre-wrapped into the frame on nowrap
  // axes) and zero the block's column sums
  {
    const int cj = tj * ts + r;
    float cx = p.pos[3 * cj], cy = p.pos[3 * cj + 1], cz = p.pos[3 * cj + 2];
    s_x[r] = nwx ? wrap_frame(cx, c0x, bx, ibx) : cx;
    s_y[r] = nwy ? wrap_frame(cy, c0y, by, iby) : cy;
    s_z[r] = nwz ? wrap_frame(cz, c0z, bz, ibz) : cz;
    s_q[r] = p.q[cj];
    s_t[r] = p.ctype[cj];
    s_g[r] = p.cgroup[cj];
    s_b[r] = p.bits[cj];
    s_o[r] = p.oid[cj];
    s_f[0][r] = 0.0f;
    s_f[1][r] = 0.0f;
    s_f[2][r] = 0.0f;
  }
  float px = p.pos[3 * row], py = p.pos[3 * row + 1], pz = p.pos[3 * row + 2];
  if (nwx) px = wrap_frame(px, c0x, bx, ibx);
  if (nwy) py = wrap_frame(py, c0y, by, iby);
  if (nwz) pz = wrap_frame(pz, c0z, bz, ibz);
  const float qrow = kOne4PiEps0 * p.q[row];
  const int bits_r = p.bits[row];
  const int oid_r = p.oid[row];
  const int K = p.K;
  const float* arow = p.ab2 + (size_t)((p.stack * ti) * ts + r) * K;
  const float* brow = p.ab2 + (size_t)((p.stack * ti + 1) * ts + r) * K;
  const float* grow = p.ab2 + (size_t)((p.stack * ti + 2) * ts + r) * K;
  const bool groups = p.stack == 3;
  __syncthreads();

  float fx = 0.f, fy = 0.f, fz = 0.f;
  float elj = 0.f, ecoul = 0.f, ecorr = 0.f;
  for (int k = 0; k < nw; ++k) {
    const int chunk = (warp + k) % nw;
    float gx = 0.f, gy = 0.f, gz = 0.f;
    for (int s = 0; s < 32; ++s) {
      const int j = chunk * 32 + ((lane + s) & 31);
      float dx = px - s_x[j];
      float dy = py - s_y[j];
      float dz = pz - s_z[j];
      if (!nwx) dx = dx - bx * rintf(dx * ibx);
      if (!nwy) dy = dy - by * rintf(dy * iby);
      if (!nwz) dz = dz - bz * rintf(dz * ibz);
      const float r2 = dx * dx + dy * dy + dz * dz;

      bool excl = false, alive = true;
      if (test_excl) {
        const int delta = s_o[j] - oid_r;
        const int bits_lo = delta >= 0 ? bits_r : s_b[j];
        const int dabs = delta >= 0 ? delta : -delta;
        const int dsh = dabs < 31 ? dabs : 31;  // a shift >= 32 is undefined
        excl = ((((unsigned)bits_lo) >> dsh) & 1u) && dabs <= 31;
        alive = delta != 0;
        excl = excl && alive;
      }
      const int ct = s_t[j];
      float a = 0.f, b = 0.f;
      if (ct >= 0) {
        a = __ldg(arow + ct);
        b = __ldg(brow + ct);
        if (groups) {
          const float allowed = __ldg(grow + p.t_dim + s_g[j]);
          a = a * allowed;
          b = b * allowed;
        }
      }
      const float qq = qrow * s_q[j];

      const float r2s = fmaxf(r2, 1e-10f);
      const float inv_r = rsqrtf(r2s);
      const float inv_r2 = inv_r * inv_r;
      const float inv_r2_lj = fminf(inv_r2, 1e6f);
      const float inv_r6 = inv_r2_lj * inv_r2_lj * inv_r2_lj;
      const float alj = a * inv_r6;
      const float a12 = alj * alj;
      const float b6 = b * inv_r6;
      float e_lj = a12 - b6;
      float f_lj = (12.0f * a12 - 6.0f * b6) * inv_r2_lj;
      if (p.r_switch > 0.f) {
        const float rr = r2s * inv_r;
        const float inv_w = 1.0f / (p.r_cutoff - p.r_switch);
        const float x = fminf(fmaxf((rr - p.r_switch) * inv_w, 0.f), 1.f);
        const float x2 = x * x;
        const float sw = 1.0f + x * x2 * (-10.0f + x * (15.0f - 6.0f * x));
        const float dsw = x2 * (-30.0f + x * (60.0f - 30.0f * x)) * inv_w;
        f_lj = f_lj * sw - e_lj * dsw * inv_r;
        e_lj = e_lj * sw;
      }
      float f_c, f_x, e_c = 0.f, e_x = 0.f;
      if (WantEnergy) {
        const float rr = r2s * inv_r;
        const float br = p.beta * rr;
        const float expm = expf(-br * br);
        const float t = 1.0f / (1.0f + 0.3275911f * br);
        const float erfc_br =
            (t * (0.254829592f +
                  t * (-0.284496736f +
                       t * (1.421413741f +
                            t * (-1.453152027f + t * 1.061405429f))))) *
            expm;
        const float gauss = p.gauss_pref * expm;
        e_c = qq * erfc_br * inv_r;
        const float erf_inv_r = (1.0f - erfc_br) * inv_r;
        e_x = -qq * erf_inv_r;
        f_x = -qq * (erf_inv_r - gauss) * inv_r2;
        f_c = qq * fminf(inv_r * inv_r2, p.cap3) + f_x;
      } else {
        float pp = p.pc[kNCoef - 1];
#pragma unroll
        for (int c = kNCoef - 2; c >= 0; --c) pp = pp * r2s + p.pc[c];
        const float w = qq * pp;
        f_c = qq * fminf(inv_r * inv_r2, p.cap3) + w;
        f_x = w;
      }
      const bool in_range = alive && !excl && (r2 < p.rc2);
      const bool corr = alive && excl;
      const float f_s = (in_range ? f_lj + f_c : 0.f) + (corr ? f_x : 0.f);
      const float fdx = f_s * dx, fdy = f_s * dy, fdz = f_s * dz;
      fx += fdx;
      fy += fdy;
      fz += fdz;
      if (WantEnergy) {
        if (in_range) {
          elj += e_lj;
          ecoul += e_c;
        }
        if (corr) ecorr += e_x;
      }
      if (!diag) {
        // the column accumulator follows its column one lane down
        gx = __shfl_sync(kFull, gx - fdx, (lane + 1) & 31);
        gy = __shfl_sync(kFull, gy - fdy, (lane + 1) & 31);
        gz = __shfl_sync(kFull, gz - fdz, (lane + 1) & 31);
      }
    }
    if (!diag) {
      // after 32 rotations lane l holds column chunk*32 + l; in this phase
      // no other warp touches this chunk
      s_f[0][chunk * 32 + lane] += gx;
      s_f[1][chunk * 32 + lane] += gy;
      s_f[2][chunk * 32 + lane] += gz;
    }
    __syncthreads();
  }

  const size_t ts_ = (size_t)ts;
  float* prow = p.prow + (size_t)e * 6 * ts_ + r;
  prow[0] = fx;
  prow[ts_] = fy;
  prow[2 * ts_] = fz;
  if (WantEnergy) {
    const float half = diag ? 0.5f : 1.0f;
    prow[3 * ts_] = half * elj;
    prow[4 * ts_] = half * ecoul;
    prow[5 * ts_] = half * ecorr;
  }
  if (!diag) {
    float* pcol = p.pcol + (size_t)e * 3 * ts_ + r;
    pcol[0] = s_f[0][r];
    pcol[ts_] = s_f[1][r];
    pcol[2 * ts_] = s_f[2][r];
  }
}

// One block per tile, one thread per atom: sums the tile's row partials
// (entries [row_ptr[t], row_ptr[t+1]), ascending) and column partials
// (entries col_idx[col_ptr[t] .. col_ptr[t+1]), ascending) in fixed order.
__global__ void __launch_bounds__(kMaxTs)
plist_reduce_kernel(const float* prow, const float* pcol, const int* row_ptr,
                    const int* col_ptr, const int* col_idx, int ts, int n_pad,
                    int n_row_vals, float* rows, float* colacc) {
  const int t = blockIdx.x;
  const int r = threadIdx.x;
  const size_t ts_ = (size_t)ts;
  float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int e = row_ptr[t]; e < row_ptr[t + 1]; ++e) {
    const float* src = prow + (size_t)e * 6 * ts_ + r;
    for (int c = 0; c < n_row_vals; ++c) acc[c] += src[c * ts_];
  }
  float* dst = rows + ((size_t)t * ts_ + r) * 8;
  for (int c = 0; c < 6; ++c) dst[c] = acc[c];
  dst[6] = 0.f;
  dst[7] = 0.f;
  float g[3] = {0.f, 0.f, 0.f};
  for (int k = col_ptr[t]; k < col_ptr[t + 1]; ++k) {
    const float* src = pcol + (size_t)col_idx[k] * 3 * ts_ + r;
    for (int c = 0; c < 3; ++c) g[c] += src[c * ts_];
  }
  const size_t col = (size_t)t * ts_ + r;
  for (int c = 0; c < 8; ++c) colacc[c * (size_t)n_pad + col] = c < 3 ? g[c] : 0.f;
}

}  // namespace

extern "C" {

// Launches the pair kernel and the reduction on `stream`; returns
// cudaGetLastError() of the launches (0 on success).
int plist_pair_launch(const int* plist, int cap, const float* pos,
                      const float* q, const float* ab2, int K, int t_dim,
                      int stack, const int* ctype, const int* cgroup,
                      const int* bits, const int* oid, const float* box,
                      int n_pad, int ts, float beta, float rc2,
                      float r_cutoff, float r_switch, float cap3,
                      float gauss_pref, const float* pcoef, int nowrap,
                      int want_energy, const int* row_ptr, const int* col_ptr,
                      const int* col_idx, float* prow, float* pcol,
                      float* rows, float* colacc, void* stream) {
  if (ts <= 0 || ts > kMaxTs || ts % 32 != 0) return (int)cudaErrorInvalidValue;
  Params p;
  p.plist = plist;
  p.pos = pos;
  p.q = q;
  p.ab2 = ab2;
  p.ctype = ctype;
  p.cgroup = cgroup;
  p.bits = bits;
  p.oid = oid;
  p.box = box;
  p.prow = prow;
  p.pcol = pcol;
  p.ts = ts;
  p.K = K;
  p.t_dim = t_dim;
  p.stack = stack;
  p.nowrap = nowrap;
  p.beta = beta;
  p.rc2 = rc2;
  p.r_cutoff = r_cutoff;
  p.r_switch = r_switch;
  p.cap3 = cap3;
  p.gauss_pref = gauss_pref;
  for (int c = 0; c < kNCoef; ++c) p.pc[c] = pcoef[c];
  cudaStream_t st = (cudaStream_t)stream;
  if (want_energy)
    plist_pair_kernel<true><<<cap, ts, 0, st>>>(p);
  else
    plist_pair_kernel<false><<<cap, ts, 0, st>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  plist_reduce_kernel<<<n_pad / ts, ts, 0, st>>>(
      prow, pcol, row_ptr, col_ptr, col_idx, ts, n_pad, want_energy ? 6 : 3,
      rows, colacc);
  return (int)cudaGetLastError();
}

const char* plist_pair_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
