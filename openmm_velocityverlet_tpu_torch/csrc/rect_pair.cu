// Kernel B3: the full rectangular pair sweep, for Hopper.
//
// Replaces openmm_velocityverlet_tpu/ops/pallas_pair.py:_pair_kernel
// (launched by _run, the symmetric=False branch of direct_space_pallas).
// Every row atom of the padded, unsorted layout meets every column atom, so
// each unordered pair is evaluated from both sides and no Newton reaction is
// kept.  Per pair (row i, column j, delta = j - i), in the JAX kernel's
// order:
//   * minimum image dx - bx * rint(dx * (1/bx)) (rintf: half to even, as
//     jnp.round; times the reciprocal, as the JAX kernel);
//   * exclusions: bit delta of the row's mask for delta in 1..31, bit -delta
//     of the column's mask for delta in -31..-1;
//   * alive = delta != 0 && i < n && j < n: pads are masked by index, not by
//     distance (a pad at 1e6 wraps back into the box under the minimum
//     image);
//   * LJ a*a/r^12 - b/r^6 with 1/max(r^2, 1e-6), then the OpenMM switch;
//     a = ab[i][type_j], b = ab[i][T + type_j], times grows[i][group_j] with
//     interaction groups: the index form of the TPU kernel's one-hot MXU
//     dots, exact in float32;
//   * Coulomb: A&S 7.1.26 erfc with a full-range expf (never __expf), the
//     direct terms within the cutoff, and the excluded-pair erf correction
//     for every alive excluded pair at any distance.
// Output fout (n_pad, 8) = fx, fy, fz, e_lj, e_coul, e_corr, 0, 0 per row.
//
// Design.  The TPU kernel carries a (tm, 1) accumulator across an in-kernel
// loop over column tiles, with the whole column table resident in VMEM.
// Here one thread owns one row atom (kRows rows a block) and walks every
// column in column order, so each row's sums are taken in one fixed order:
// bitwise deterministic with no atomics and no second pass.  Column tiles of
// kTile atoms (position, charge, exclusion mask, LJ type and group: 28 B a
// column, 14 KB a tile) are staged in shared memory by the whole block and
// read by every thread as a broadcast.  The row's LJ row (ab) and group row
// stay in global memory behind __ldg: T and G are small, so they live in L1.
//
// Bound: arithmetic.  A pair within the cutoff costs 73 FP32 operations
// (RECT_OPS in chip_smoke.py, counted below); device-memory traffic is the
// column tables read once per block (n_pad / kRows times), tiny beside
// that.  The sweep visits all n_pad^2 ordered pairs, ~99% of them outside
// the cutoff at 19.5k atoms: those cost the minimum image, r^2 and the
// masks (~25 operations) and skip the rest, which changes no sum (a masked
// pair adds zero).  At 19,968 atoms one thread per row gives 156 blocks of
// 4 warps on 132 SMs, a low occupancy that the first version accepts.
//
// FP32 operations per pair within the cutoff (rsqrtf, rintf, fminf/fmaxf,
// division and expf count one each, a fused multiply-add two): minimum
// image 15, r^2 5, cutoff test 1, qq 1, r2s/inv_r/inv_r2/r 4, erfc 16,
// gauss 1, LJ 15, e_c 2, f_c 4, f_s 1, force sums 6, energy sums 2: 73
// (2 more with interaction groups).

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 128;  // row atoms (threads) per block
constexpr int kTile = 512;  // column atoms per shared-memory tile
constexpr float kOne4PiEps0 = 138.935456f;

struct Params {
  const float* pos;    // (n_pad, 3)
  const float* q;      // (n_pad,)
  const float* ab;     // (n_pad, ab_w) rows [A | B ...]
  const int* ctype;    // (n_pad,) LJ type, -1 on pad atoms
  const int* cgroup;   // (n_pad,) interaction group
  const float* grows;  // (n_pad, g_dim) group-allowed rows, or null
  const int* bits;     // (n_pad,) exclusion masks
  const float* box;    // (3,)
  float* fout;         // (n_pad, 8)
  int ab_w, t_dim, g_dim, n_pad, n;
  float beta, rc2, r_cutoff, r_switch, gauss_pref;
};

__global__ void __launch_bounds__(kRows) rect_pair_kernel(Params p) {
  __shared__ float s_x[kTile], s_y[kTile], s_z[kTile], s_q[kTile];
  __shared__ int s_t[kTile], s_g[kTile], s_b[kTile];

  const int row = blockIdx.x * kRows + threadIdx.x;
  const bool has_row = row < p.n_pad;
  const bool groups = p.grows != nullptr;
  float px = 0.f, py = 0.f, pz = 0.f, qrow = 0.f;
  unsigned bits_r = 0u;
  const float* arow = p.ab;
  const float* grow = p.grows;
  if (has_row) {
    px = p.pos[3 * row];
    py = p.pos[3 * row + 1];
    pz = p.pos[3 * row + 2];
    qrow = kOne4PiEps0 * p.q[row];
    bits_r = (unsigned)p.bits[row];
    arow = p.ab + (size_t)row * p.ab_w;
    if (groups) grow = p.grows + (size_t)row * p.g_dim;
  }
  const bool row_real = row < p.n;
  const float bx = p.box[0], by = p.box[1], bz = p.box[2];
  const float ibx = 1.0f / bx, iby = 1.0f / by, ibz = 1.0f / bz;
  const int T = p.t_dim;

  float fx = 0.f, fy = 0.f, fz = 0.f, elj = 0.f, ecoul = 0.f, ecorr = 0.f;
  for (int c0 = 0; c0 < p.n_pad; c0 += kTile) {
    const int nc = min(kTile, p.n_pad - c0);
    __syncthreads();  // the previous tile is no longer read
    for (int k = threadIdx.x; k < nc; k += kRows) {
      const int cj = c0 + k;
      s_x[k] = p.pos[3 * cj];
      s_y[k] = p.pos[3 * cj + 1];
      s_z[k] = p.pos[3 * cj + 2];
      s_q[k] = p.q[cj];
      s_t[k] = p.ctype[cj];
      s_g[k] = p.cgroup[cj];
      s_b[k] = p.bits[cj];
    }
    __syncthreads();
    if (!has_row) continue;
    for (int k = 0; k < nc; ++k) {
      const int col = c0 + k;
      float dx = px - s_x[k];
      float dy = py - s_y[k];
      float dz = pz - s_z[k];
      dx = dx - bx * rintf(dx * ibx);
      dy = dy - by * rintf(dy * iby);
      dz = dz - bz * rintf(dz * ibz);
      const float r2 = dx * dx + dy * dy + dz * dz;

      const int delta = col - row;
      bool excl = false;
      if (delta >= 1 && delta <= 31) {
        excl = (bits_r >> delta) & 1u;
      } else if (delta <= -1 && delta >= -31) {
        excl = (((unsigned)s_b[k]) >> (-delta)) & 1u;
      }
      const bool alive = delta != 0 && row_real && col < p.n;
      const bool in_range = alive && !excl && r2 < p.rc2;
      const bool corr = alive && excl;
      if (!in_range && !corr) continue;

      const int ct = s_t[k];
      float a = 0.f, b = 0.f;
      if (ct >= 0) {
        a = __ldg(arow + ct);
        b = __ldg(arow + T + ct);
        if (groups) {
          const float allowed = __ldg(grow + s_g[k]);
          a = a * allowed;
          b = b * allowed;
        }
      }
      const float qq = qrow * s_q[k];
      const float r2s = fmaxf(r2, 1e-10f);
      const float inv_r = rsqrtf(r2s);
      const float inv_r2 = inv_r * inv_r;
      const float r = r2s * inv_r;

      // the Coulomb kernel: A&S 7.1.26 erfc, full-range expf
      const float br = p.beta * r;
      const float expm = expf(-br * br);
      const float t = 1.0f / (1.0f + 0.3275911f * br);
      const float erfc_br =
          (t * (0.254829592f +
                t * (-0.284496736f +
                     t * (1.421413741f +
                          t * (-1.453152027f + t * 1.061405429f))))) *
          expm;
      const float gauss = p.gauss_pref * expm;
      if (in_range) {
        const float inv_r2_lj = 1.0f / fmaxf(r2, 1e-6f);
        const float inv_r6 = inv_r2_lj * inv_r2_lj * inv_r2_lj;
        const float inv_r12 = inv_r6 * inv_r6;
        float e_lj = a * a * inv_r12 - b * inv_r6;
        float f_lj = (12.0f * a * a * inv_r12 - 6.0f * b * inv_r6) * inv_r2_lj;
        if (p.r_switch > 0.f) {
          const float inv_w = 1.0f / (p.r_cutoff - p.r_switch);
          const float x = fminf(fmaxf((r - p.r_switch) * inv_w, 0.f), 1.f);
          const float x2 = x * x;
          const float sw = 1.0f + x * x2 * (-10.0f + x * (15.0f - 6.0f * x));
          const float dsw = x2 * (-30.0f + x * (60.0f - 30.0f * x)) * inv_w;
          f_lj = f_lj * sw - e_lj * dsw * inv_r;
          e_lj = e_lj * sw;
        }
        const float e_c = qq * erfc_br * inv_r;
        const float f_c = qq * (erfc_br * inv_r + gauss) * inv_r2;
        const float f_s = f_lj + f_c;
        fx += f_s * dx;
        fy += f_s * dy;
        fz += f_s * dz;
        elj += e_lj;
        ecoul += e_c;
      } else {
        const float erf_inv_r = (1.0f - erfc_br) * inv_r;
        const float f_x = -qq * (erf_inv_r - gauss) * inv_r2;
        fx += f_x * dx;
        fy += f_x * dy;
        fz += f_x * dz;
        ecorr += -qq * erf_inv_r;
      }
    }
  }
  if (has_row) {
    float* out = p.fout + (size_t)row * 8;
    out[0] = fx;
    out[1] = fy;
    out[2] = fz;
    out[3] = elj;
    out[4] = ecoul;
    out[5] = ecorr;
    out[6] = 0.f;
    out[7] = 0.f;
  }
}

}  // namespace

extern "C" {

// Launches the sweep on `stream`; returns cudaGetLastError() of the launch
// (0 on success).
int rect_pair_launch(const float* pos, const float* q, const float* ab,
                     int ab_w, int t_dim, const int* ctype, const int* cgroup,
                     const float* grows, int g_dim, const int* bits,
                     const float* box, int n_pad, int n, float beta,
                     float rc2, float r_cutoff, float r_switch,
                     float gauss_pref, float* fout, void* stream) {
  if (n_pad < 0 || n < 0 || n > n_pad || t_dim < 1 || ab_w < 2 * t_dim)
    return (int)cudaErrorInvalidValue;
  if (n_pad == 0) return 0;
  Params p;
  p.pos = pos;
  p.q = q;
  p.ab = ab;
  p.ctype = ctype;
  p.cgroup = cgroup;
  p.grows = grows;
  p.bits = bits;
  p.box = box;
  p.fout = fout;
  p.ab_w = ab_w;
  p.t_dim = t_dim;
  p.g_dim = g_dim;
  p.n_pad = n_pad;
  p.n = n;
  p.beta = beta;
  p.rc2 = rc2;
  p.r_cutoff = r_cutoff;
  p.r_switch = r_switch;
  p.gauss_pref = gauss_pref;
  const int blocks = (n_pad + kRows - 1) / kRows;
  rect_pair_kernel<<<blocks, kRows, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

const char* rect_pair_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
