// Kernel B2: the upper-triangle tile sweep (z band, band + far, and the
// exhaustive full sweep), for Hopper.
//
// Replaces openmm_velocityverlet_tpu/ops/pallas_pair.py:_pair_tri_kernel
// (launched by _tri_call / _run_tri).  For every tile pair (i, j) of one
// enumeration it computes the LJ + Ewald direct-space + exclusion-correction
// interactions of the (ts x ts) block, Newton's third law giving the column
// atoms the reaction:
//   * mode 0 "band":    j = i, i+1 on the unsorted layout; exclusions tested
//     on index positions;
//   * mode 1 "far":     j >= i+2, cutoff mask only (no exclusion can reach
//     that far in index order), always with the column reaction;
//   * mode 2 "bandall": j = (i+o) mod n_tiles, o = 0..band_w, on the z-sorted
//     layout, exclusions tested on the carried original indices; with
//     full_sweep every unordered tile pair (band_w = n_tiles/2, and for an
//     even tile count the pair at offset n_tiles/2 only when i < j).
// Per pair: minimum image (rintf, half to even as jnp.round); the exclusion
// and folded 1-4 bits of the lower original index, selected by the sign of
// delta; LJ (a/r^6)^2 - b/r^6 with 1/r^2 capped at 1e6 and the bare Coulomb
// 1/r^3 capped at 1/0.045^3 (pads sit at 1e6 with zero charge and zero LJ
// and cancel only in these forms); the force-only Chebyshev polynomial
// (coefficients from the host's _pfit_scaled) or the energy form with the
// A&S erfc; folded 1-4 pairs add 0.5 qq/r + (a14/r^6)^2 - b14/r^6.  A
// diagonal tile halves its energies and, in the exclusion-testing modes,
// adds no column reaction.  LJ coefficients are a direct lookup by the
// column atom's type (ab[row][type], times grows[row][group]): the index form
// of the TPU kernel's one-hot MXU dots, exact in float32.
// Outputs keep the JAX layout: rows (n_pad, 8) = fx, fy, fz, e_lj, e_coul,
// e_corr, e14_coul, e14_lj and colacc (8, n_pad) with the reaction in rows
// 0..2.
//
// Design.  The TPU grid runs in order, so the Pallas kernel accumulates a
// row tile and the whole column accumulator in VMEM across grid steps.  Here
// every tile pair of the enumeration is one block (one thread per row atom,
// ts up to 768) that writes its row and column partial sums to a per-entry
// buffer; a second kernel sums them per tile in a fixed order computed from
// the enumeration (rows ascending in entry, columns by offset).  Inside a
// block the column accumulator rotates one lane per step through the warp
// (__shfl_sync) and the warps add their chunk sums in a fixed phase order,
// as in kernel B1.  No atomics: the result is bitwise deterministic from run
// to run (checked by chip_smoke.py and tests/test_torch_kernels.py).
//
// Bound: arithmetic.  A tile pair reads ~10 words per column atom once into
// shared memory and then does ~40-70 FP32 operations per pair for ts^2 pairs
// (more with the energy form or 1-4 folding); device-memory traffic is the
// per-entry partials, 11 words per atom per entry, small beside that.  The
// exclusion integer ops are compiled out of the far mode, and the 1-4 path
// out of systems without folded exceptions (template parameters).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxTs = 768;
constexpr int kNCoef = 11;
constexpr float kOne4PiEps0 = 138.935456f;
constexpr unsigned kFull = 0xffffffffu;
enum Mode { kBand = 0, kFar = 1, kBandAll = 2 };

struct Params {
  const float* pos;     // (n_pad, 3)
  const float* q;       // (n_pad,)
  const float* ab;      // (n_pad, ab_w) rows [A | B (| A14 | B14)]
  const int* ctype;     // (n_pad,) LJ type, -1 on pad atoms
  const int* cgroup;    // (n_pad,) interaction group
  const float* grows;   // (n_pad, g_dim) group-allowed rows, or null
  const int* bits;      // (n_pad,) exclusion masks
  const int* bits14;    // (n_pad,) folded 1-4 masks
  const int* oid;       // (n_pad,) original atom indices
  const float* box;     // (3,)
  float* prow;          // (n_entries, 8, ts) per-entry row partials
  float* pcol;          // (n_entries, 3, ts) per-entry column partials
  int ab_w, t_dim, g_dim, ts, n_tiles, mode, band_w, full_sweep;
  float beta, rc2, r_cutoff, r_switch, cap3, gauss_pref;
  float pc[kNCoef];
};

// Tile pair of entry e; false for an entry the enumeration skips.
__device__ __forceinline__ bool entry_tiles(const Params& p, int e, int* ti,
                                            int* tj) {
  const int nt = p.n_tiles;
  if (p.mode == kBandAll) {
    const int w1 = p.band_w + 1;
    const int i = e / w1;
    const int o = e - i * w1;
    const int j = (i + o) % nt;
    *ti = i;
    *tj = j;
    // offset nt/2 enumerates each unordered pair twice: keep i < j
    if (p.full_sweep && (nt % 2 == 0) && 2 * o == nt) return i < j;
    return true;
  }
  if (p.mode == kBand) {
    const int i = e >> 1;
    const int j = i + (e & 1);
    *ti = i;
    *tj = j;
    return j < nt;
  }
  const int i = e / nt;
  const int j = e - i * nt;
  *ti = i;
  *tj = j;
  return j >= i + 2;
}

template <bool WantEnergy, bool TestExcl, bool Has14>
__global__ void __launch_bounds__(kMaxTs)
tri_pair_kernel(Params p) {
  int ti, tj;
  const int e = blockIdx.x;
  if (!entry_tiles(p, e, &ti, &tj)) return;  // uniform for the block
  const bool diag = ti == tj;
  const bool by_position = p.mode == kBand;
  const bool groups = p.grows != nullptr;
  const int ts = p.ts;
  const int r = threadIdx.x;
  const int lane = r & 31;
  const int warp = r >> 5;
  const int nw = ts >> 5;

  __shared__ float s_x[kMaxTs], s_y[kMaxTs], s_z[kMaxTs], s_q[kMaxTs];
  __shared__ int s_t[kMaxTs], s_g[kMaxTs], s_b[kMaxTs], s_b14[kMaxTs],
      s_o[kMaxTs];
  __shared__ float s_f[3][kMaxTs];

  {
    const int cj = tj * ts + r;
    s_x[r] = p.pos[3 * cj];
    s_y[r] = p.pos[3 * cj + 1];
    s_z[r] = p.pos[3 * cj + 2];
    s_q[r] = p.q[cj];
    s_t[r] = p.ctype[cj];
    s_g[r] = p.cgroup[cj];
    if (TestExcl) {
      s_b[r] = p.bits[cj];
      s_o[r] = by_position ? cj : p.oid[cj];
      if (Has14) s_b14[r] = p.bits14[cj];
    }
    s_f[0][r] = 0.0f;
    s_f[1][r] = 0.0f;
    s_f[2][r] = 0.0f;
  }
  const int row = ti * ts + r;
  const float px = p.pos[3 * row], py = p.pos[3 * row + 1],
              pz = p.pos[3 * row + 2];
  const float bx = p.box[0], by = p.box[1], bz = p.box[2];
  const float ibx = 1.0f / bx, iby = 1.0f / by, ibz = 1.0f / bz;
  const float qrow = kOne4PiEps0 * p.q[row];
  int bits_r = 0, bits14_r = 0, oid_r = 0;
  if (TestExcl) {
    bits_r = p.bits[row];
    oid_r = by_position ? row : p.oid[row];
    if (Has14) bits14_r = p.bits14[row];
  }
  const int T = p.t_dim;
  const float* arow = p.ab + (size_t)row * p.ab_w;
  const float* grow = groups ? p.grows + (size_t)row * p.g_dim : nullptr;
  __syncthreads();

  float fx = 0.f, fy = 0.f, fz = 0.f;
  float elj = 0.f, ecoul = 0.f, ecorr = 0.f, e14c = 0.f, e14l = 0.f;
  for (int k = 0; k < nw; ++k) {
    const int chunk = (warp + k) % nw;
    float gx = 0.f, gy = 0.f, gz = 0.f;
    for (int s = 0; s < 32; ++s) {
      const int j = chunk * 32 + ((lane + s) & 31);
      float dx = px - s_x[j];
      float dy = py - s_y[j];
      float dz = pz - s_z[j];
      dx = dx - bx * rintf(dx * ibx);
      dy = dy - by * rintf(dy * iby);
      dz = dz - bz * rintf(dz * ibz);
      const float r2 = dx * dx + dy * dy + dz * dz;

      bool excl = false, alive = true, is14 = false;
      if (TestExcl) {
        const int delta = s_o[j] - oid_r;
        const bool side = delta >= 0;
        const int dabs = side ? delta : -delta;
        const int dsh = dabs < 31 ? dabs : 31;  // a shift >= 32 is undefined
        const bool window = dabs <= 31;
        alive = delta != 0;
        const int bits_lo = side ? bits_r : s_b[j];
        excl = ((((unsigned)bits_lo) >> dsh) & 1u) && window && alive;
        if (Has14) {
          const int b14_lo = side ? bits14_r : s_b14[j];
          is14 = ((((unsigned)b14_lo) >> dsh) & 1u) && window && alive;
        }
      }
      const int ct = s_t[j];
      float a = 0.f, b = 0.f, a14 = 0.f, b14 = 0.f;
      if (ct >= 0) {
        a = __ldg(arow + ct);
        b = __ldg(arow + T + ct);
        if (groups) {
          const float allowed = __ldg(grow + s_g[j]);
          a = a * allowed;
          b = b * allowed;
        }
        if (Has14) {
          a14 = __ldg(arow + 2 * T + ct);
          b14 = __ldg(arow + 3 * T + ct);
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
      float f_s;
      bool in_range;
      if (TestExcl) {
        in_range = alive && !excl && (r2 < p.rc2);
        const bool corr = alive && excl;
        f_s = (in_range ? f_lj + f_c : 0.f) + (corr ? f_x : 0.f);
        if (WantEnergy && corr) ecorr += e_x;
        if (Has14 && is14) {
          const float e14_c = 0.5f * qq * inv_r;
          const float a14lj = a14 * inv_r6;
          const float e14_12 = a14lj * a14lj;
          const float e14_6 = b14 * inv_r6;
          f_s += (e14_c + 12.0f * e14_12 - 6.0f * e14_6) * inv_r2;
          if (WantEnergy) {
            e14c += e14_c;
            e14l += e14_12 - e14_6;
          }
        }
      } else {
        in_range = r2 < p.rc2;
        f_s = in_range ? f_lj + f_c : 0.f;
      }
      const float fdx = f_s * dx, fdy = f_s * dy, fdz = f_s * dz;
      fx += fdx;
      fy += fdy;
      fz += fdz;
      if (WantEnergy && in_range) {
        elj += e_lj;
        ecoul += e_c;
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
  float* prow = p.prow + (size_t)e * 8 * ts_ + r;
  prow[0] = fx;
  prow[ts_] = fy;
  prow[2 * ts_] = fz;
  if (WantEnergy) {
    const float half = diag ? 0.5f : 1.0f;
    prow[3 * ts_] = half * elj;
    prow[4 * ts_] = half * ecoul;
    prow[5 * ts_] = half * ecorr;
    prow[6 * ts_] = half * e14c;
    prow[7 * ts_] = half * e14l;
  }
  if (!diag) {
    float* pcol = p.pcol + (size_t)e * 3 * ts_ + r;
    pcol[0] = s_f[0][r];
    pcol[ts_] = s_f[1][r];
    pcol[2 * ts_] = s_f[2][r];
  }
}

// One block per tile t, one thread per atom: sums the row partials of the
// entries with row tile t (ascending entry) and the column partials of the
// off-diagonal entries with column tile t (ascending offset), in a fixed
// order computed from the enumeration.
__global__ void __launch_bounds__(kMaxTs)
tri_reduce_kernel(Params p, int n_row_vals, float* rows, float* colacc) {
  const int t = blockIdx.x;
  const int r = threadIdx.x;
  const int nt = p.n_tiles;
  const size_t ts_ = (size_t)p.ts;
  int e0, e1;
  if (p.mode == kBandAll) {
    e0 = t * (p.band_w + 1);
    e1 = e0 + p.band_w + 1;
  } else if (p.mode == kBand) {
    e0 = 2 * t;
    e1 = e0 + 2;
  } else {
    e0 = t * nt;
    e1 = e0 + nt;
  }
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  int ti, tj;
  for (int e = e0; e < e1; ++e) {
    if (!entry_tiles(p, e, &ti, &tj)) continue;
    const float* src = p.prow + (size_t)e * 8 * ts_ + r;
    for (int c = 0; c < n_row_vals; ++c) acc[c] += src[c * ts_];
  }
  float* dst = rows + ((size_t)t * ts_ + r) * 8;
  for (int c = 0; c < 8; ++c) dst[c] = acc[c];

  float g[3] = {0.f, 0.f, 0.f};
  // the entries whose column tile is t: bandall one per offset o, band the
  // first off-diagonal of row t-1, far every row i <= t-2
  const int n_src = p.mode == kBandAll ? p.band_w + 1
                    : p.mode == kBand  ? 1
                                       : (t >= 2 ? t - 1 : 0);
  for (int k = 0; k < n_src; ++k) {
    int e;
    if (p.mode == kBandAll) {
      const int i = ((t - k) % nt + nt) % nt;
      e = i * (p.band_w + 1) + k;
    } else if (p.mode == kBand) {
      if (t < 1) break;
      e = 2 * (t - 1) + 1;
    } else {
      e = k * nt + t;
    }
    if (!entry_tiles(p, e, &ti, &tj) || ti == tj || tj != t) continue;
    const float* src = p.pcol + (size_t)e * 3 * ts_ + r;
    for (int c = 0; c < 3; ++c) g[c] += src[c * ts_];
  }
  const size_t col = (size_t)t * ts_ + r;
  const size_t n_pad = (size_t)nt * ts_;
  for (int c = 0; c < 8; ++c) colacc[c * n_pad + col] = c < 3 ? g[c] : 0.f;
}

template <bool WantEnergy>
cudaError_t launch_pairs(const Params& p, int n_entries, cudaStream_t st) {
  if (p.mode == kFar) {
    tri_pair_kernel<WantEnergy, false, false><<<n_entries, p.ts, 0, st>>>(p);
  } else if (p.bits14 != nullptr) {
    tri_pair_kernel<WantEnergy, true, true><<<n_entries, p.ts, 0, st>>>(p);
  } else {
    tri_pair_kernel<WantEnergy, true, false><<<n_entries, p.ts, 0, st>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the pair kernel of one enumeration and the reduction on
// `stream`; returns cudaGetLastError() of the launches (0 on success).
int tri_pair_launch(const float* pos, const float* q, const float* ab,
                    int ab_w, int t_dim, const int* ctype, const int* cgroup,
                    const float* grows, int g_dim, const int* bits,
                    const int* bits14, const int* oid, const float* box,
                    int n_pad, int ts, int mode, int band_w, int full_sweep,
                    int want_energy, int has14, float beta, float rc2,
                    float r_cutoff, float r_switch, float cap3,
                    float gauss_pref, const float* pcoef, float* prow,
                    float* pcol, float* rows, float* colacc, void* stream) {
  if (ts < 32 || ts > kMaxTs || ts % 32 != 0 || n_pad % ts != 0 ||
      mode < kBand || mode > kBandAll || band_w < 0)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.pos = pos;
  p.q = q;
  p.ab = ab;
  p.ctype = ctype;
  p.cgroup = cgroup;
  p.grows = grows;
  p.bits = bits;
  p.bits14 = has14 ? bits14 : nullptr;
  p.oid = oid;
  p.box = box;
  p.prow = prow;
  p.pcol = pcol;
  p.ab_w = ab_w;
  p.t_dim = t_dim;
  p.g_dim = g_dim;
  p.ts = ts;
  p.n_tiles = n_pad / ts;
  p.mode = mode;
  p.band_w = mode == kBandAll ? band_w : 0;
  p.full_sweep = full_sweep;
  p.beta = beta;
  p.rc2 = rc2;
  p.r_cutoff = r_cutoff;
  p.r_switch = r_switch;
  p.cap3 = cap3;
  p.gauss_pref = gauss_pref;
  for (int c = 0; c < kNCoef; ++c) p.pc[c] = pcoef[c];
  const int nt = p.n_tiles;
  if (nt == 0) return 0;
  const int n_entries = mode == kBandAll ? nt * (p.band_w + 1)
                        : mode == kBand  ? 2 * nt
                                         : nt * nt;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = want_energy ? launch_pairs<true>(p, n_entries, st)
                                : launch_pairs<false>(p, n_entries, st);
  if (err != cudaSuccess) return (int)err;
  tri_reduce_kernel<<<nt, ts, 0, st>>>(p, want_energy ? 8 : 3, rows, colacc);
  return (int)cudaGetLastError();
}

const char* tri_pair_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
