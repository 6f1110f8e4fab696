// Kernel B3: the full rectangular pair sweep, for Hopper.
//
// Replaces openmm_velocityverlet_tpu/ops/pallas_pair.py:_pair_kernel
// (launched by _run, the symmetric=False branch of direct_space_pallas).
// Every real row atom meets every real column atom, so each unordered pair
// is evaluated from both sides and no Newton reaction is kept.  Per pair
// (row i, column j in original indices, delta = j - i), in the JAX
// kernel's order:
//   * minimum image dx - bx * rint(dx * (1/bx)) on the positions as given
//     (rintf: half to even, as jnp.round; times the reciprocal, as the JAX
//     kernel);
//   * exclusions: bit |delta| of the lower index's mask for |delta| in
//     1..31;
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
// Bound: arithmetic.  A pair within the cutoff costs 73 FP32 operations
// (RECT_OPS in chip_smoke.py, counted below); the bytes (positions and
// per-atom columns, the output) are small next to that.  What a sweep loses
// against the bound is the pairs it evaluates beyond the cutoff: the TPU
// kernel, and this kernel's first design, evaluated all n_pad^2 ordered
// pairs, 268 for each pair within the cutoff at 19,500 atoms.
//
// Design (the chunk boxes and column vote of kernels B1 and B2, without a
// list and without a column reaction).
//   * Layout.  The wrapper (ops/pair_rect.py:rect_layout, plain torch on
//     the card) sorts the n real atoms in stable Morton order of their
//     wrapped positions and cuts them into chunks of 32 slots: `oid` gives
//     each slot's original index (-1 on the slots that fill the last
//     chunk), `cbox` each chunk's bounding box (centre, half extent grown
//     by 1e-3 nm).  Pads never enter a chunk.  The pair arithmetic reads
//     the original arrays through `oid`, on the positions as given.
//   * One block a row chunk, kWarps = 16 warps (at 19,500 atoms 610 blocks
//     of 512 threads; 4 and 8 warps measured slower), each warp holding the
//     32 row atoms one a lane.  The block first tests its box against every
//     column chunk's box (the periodic gap between the two boxes against
//     the cutoff, 32 chunks a ballot; (n/32)^2 tests in all, no list, no
//     host read, no capacity).  The kept chunks go to the warps in turn, in
//     chunk order.  In a kept chunk each lane loads one column atom and
//     tests its distance to the row box; the ballot gives the columns to
//     visit, four a round (four independent chains for the scheduler).
//     Both distances bound every pair's minimum-image distance from below,
//     so no pair within the cutoff is dropped; the squared reach is the
//     cutoff's grown by 1e-4 (ops/pair_rect.py:skip_r2).
//   * The rows' LJ rows (a, b by column type) and group rows are read with
//     __ldg: T and G are small, so they live in L1 (staging them in shared
//     memory measured no faster).
//   * Excluded pairs count at any distance, so the culled pass skips every
//     excluded pair, and warp 0 adds them in a band pass over original
//     indices (i - 31 .. i + 31) after the reduction: 62 mask tests a row.
//   * Fixed order, no atomics: each warp writes its row partials to shared
//     memory, warp 0 adds them in warp order, then the band pass, and
//     writes the row of `oid`.  Bitwise equal from run to run.
//   * Rows n..n_pad of fout are written as zeros by a grid-stride loop.
//   * `evals[c]` counts the ordered pair evaluations of row chunk c (32
//     rows times four columns a round), for the record.
//
// Rounding: the kernel adds each row's pairs in another order than its
// plain version, so the two agree to float32 rounding, not bitwise.
//
// FP32 operations per pair within the cutoff (rsqrtf, rintf, fminf/fmaxf,
// division and expf count one each, a fused multiply-add two): minimum
// image 15, r^2 5, cutoff test 1, qq 1, r2s/inv_r/inv_r2/r 4, erfc 16,
// gauss 1, LJ 15, e_c 2, f_c 4, f_s 1, force sums 6, energy sums 2: 73
// (2 more with interaction groups).

#include <cuda_runtime.h>

namespace {

constexpr int kBatch = 4;       // columns a round of the pair loop
constexpr int kWarps = 16;      // warps a block, all on one row chunk
constexpr int kParts = 5;       // fx, fy, fz, e_lj, e_coul
constexpr int kMaxExcl = 31;    // MAX_EXCL_OFFSET
constexpr float kOne4PiEps0 = 138.935456f;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const float* pos;    // (n_pad, 3), original order
  const float* q;      // (n_pad,)
  const float* ab;     // (n_pad, ab_w) rows [A | B ...]
  const int* ctype;    // (n_pad,) LJ type
  const int* cgroup;   // (n_pad,) interaction group
  const float* grows;  // (n_pad, g_dim) group-allowed rows, or null
  const int* bits;     // (n_pad,) exclusion masks
  const float* box;    // (3,)
  const int* oid;      // (n_c * 32,) original index of each slot, -1: none
  const float4* cbox;  // (n_c, 2): chunk box centre, half extent
  float* fout;         // (n_pad, 8)
  long long* evals;    // (n_c,)
  int ab_w, t_dim, g_dim, n_pad, n, n_c;
  float beta, rc2, skip_r2, r_cutoff, r_switch, gauss_pref;
};

__device__ __forceinline__ float min_image(float d, float L, float iL) {
  return d - L * rintf(d * iL);
}

// The A&S 7.1.26 erfc(beta r) with a full-range expf, and the Gaussian
// term gauss_pref * exp(-(beta r)^2).
__device__ __forceinline__ void coulomb(const Params& p, float r,
                                        float* erfc_br, float* gauss) {
  const float br = p.beta * r;
  const float expm = expf(-br * br);
  const float t = 1.0f / (1.0f + 0.3275911f * br);
  *erfc_br =
      (t * (0.254829592f +
            t * (-0.284496736f +
                 t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))))) *
      expm;
  *gauss = p.gauss_pref * expm;
}

// Squared gap of u beyond the half extents (hx, hy, hz) after the minimum
// image: a lower bound of the distances of the pairs the boxes hold.
__device__ __forceinline__ float gap2(float ux, float uy, float uz, float hx,
                                      float hy, float hz, const float* L,
                                      const float* iL) {
  const float gx = fmaxf(fabsf(min_image(ux, L[0], iL[0])) - hx, 0.f);
  const float gy = fmaxf(fabsf(min_image(uy, L[1], iL[1])) - hy, 0.f);
  const float gz = fmaxf(fabsf(min_image(uz, L[2], iL[2])) - hz, 0.f);
  return gx * gx + gy * gy + gz * gz;
}

// Shared memory: per warp 32 column atoms as float4 (x, y, z, q) and int4
// (type, group, mask, original index), its row partials and evaluation
// count; the block's kept-chunk bitmap, one word for 32 column chunks, is
// dynamic (n_c / 32 words).
constexpr int kStaticSmem =
    kWarps * (32 * (int)sizeof(float4) + 32 * (int)sizeof(int4) +
              kParts * 32 * (int)sizeof(float) + (int)sizeof(unsigned));

__global__ void __launch_bounds__(kWarps * 32) rect_pair_kernel(Params p) {
  __shared__ float4 s_col[kWarps][32];
  __shared__ int4 s_idx[kWarps][32];
  __shared__ float s_part[kWarps * kParts * 32];
  __shared__ unsigned s_ev[kWarps];
  extern __shared__ unsigned s_mask[];
  constexpr int S = kWarps;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float4* s_c = s_col[warp];
  int4* s_i = s_idx[warp];

  // rows n..n_pad: zeros
  for (int z = p.n + blockIdx.x * blockDim.x + threadIdx.x; z < p.n_pad;
       z += gridDim.x * blockDim.x) {
    float4* o = reinterpret_cast<float4*>(p.fout + (size_t)z * 8);
    o[0] = make_float4(0.f, 0.f, 0.f, 0.f);
    o[1] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const int rc = blockIdx.x;
  if (rc >= p.n_c) return;  // the whole block: n = 0 launches one block

  const float L[3] = {p.box[0], p.box[1], p.box[2]};
  const float iL[3] = {1.0f / L[0], 1.0f / L[1], 1.0f / L[2]};
  const float4 m = p.cbox[2 * rc], h = p.cbox[2 * rc + 1];
  const int n_words = (p.n_c + 31) >> 5;

  // 1. the column chunks in reach of this row chunk, 32 a ballot
  for (int w = warp; w < n_words; w += S) {
    const int cc = w * 32 + lane;
    bool reach = false;
    if (cc < p.n_c) {
      const float4 cm = p.cbox[2 * cc], ch = p.cbox[2 * cc + 1];
      reach = gap2(cm.x - m.x, cm.y - m.y, cm.z - m.z, h.x + ch.x, h.y + ch.y,
                   h.z + ch.z, L, iL) <= p.skip_r2;
    }
    const unsigned b = __ballot_sync(kFull, reach);
    if (lane == 0) s_mask[w] = b;
  }

  // the row atom of this lane
  const int oid_r = p.oid[rc * 32 + lane];
  const bool row_real = oid_r >= 0;
  const int ri = row_real ? oid_r : 0;
  const float px = p.pos[3 * ri], py = p.pos[3 * ri + 1],
              pz = p.pos[3 * ri + 2];
  const float qrow = kOne4PiEps0 * p.q[ri];
  const unsigned bits_r = (unsigned)p.bits[ri];
  const float* arow = p.ab + (size_t)ri * p.ab_w;
  const bool groups = p.grows != nullptr;
  const float* grow = groups ? p.grows + (size_t)ri * p.g_dim : nullptr;
  const int T = p.t_dim;
  const float inv_w =
      p.r_switch > 0.f ? 1.0f / (p.r_cutoff - p.r_switch) : 0.f;
  __syncthreads();

  // 2. the kept chunks, dealt to the warps in turn
  float fx = 0.f, fy = 0.f, fz = 0.f, elj = 0.f, ecoul = 0.f;
  unsigned n_eval = 0;
  int k = 0;
  for (int w = 0; w < n_words; ++w) {
    unsigned word = s_mask[w];
    while (word != 0) {
      const int bit = __ffs(word) - 1;
      word &= word - 1;
      if (k++ % S != warp) continue;
      const int cc = w * 32 + bit;
      const int oid_c = p.oid[cc * 32 + lane];
      const bool col_real = oid_c >= 0;
      const int ci = col_real ? oid_c : 0;
      const float cx = p.pos[3 * ci], cy = p.pos[3 * ci + 1],
                  cz = p.pos[3 * ci + 2];
      const bool keep =
          col_real && gap2(cx - m.x, cy - m.y, cz - m.z, h.x, h.y, h.z, L,
                           iL) <= p.skip_r2;
      unsigned mask = __ballot_sync(kFull, keep);
      __syncwarp();
      s_c[lane] = make_float4(cx, cy, cz, p.q[ci]);
      s_i[lane] = make_int4(p.ctype[ci], p.cgroup[ci], p.bits[ci], oid_c);
      __syncwarp();
      while (mask != 0) {
        int jb[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          jb[u] = mask != 0 ? __ffs(mask) - 1 : -1;
          mask &= mask - 1;
        }
        n_eval += 32u * kBatch;
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const bool live = jb[u] >= 0;  // an empty slot computes column 0
          const int j = live ? jb[u] : 0;  // for nothing
          const float4 c = s_c[j];
          const int4 ci4 = s_i[j];
          const float dx = min_image(px - c.x, L[0], iL[0]);
          const float dy = min_image(py - c.y, L[1], iL[1]);
          const float dz = min_image(pz - c.z, L[2], iL[2]);
          const float r2 = dx * dx + dy * dy + dz * dz;
          const int delta = ci4.w - oid_r;
          const int dabs = delta >= 0 ? delta : -delta;
          const unsigned lower = delta > 0 ? bits_r : (unsigned)ci4.z;
          const bool excl =
              dabs <= kMaxExcl && ((lower >> (dabs & 31)) & 1u) != 0u;
          const bool in_range =
              live && row_real && delta != 0 && !excl && r2 < p.rc2;

          const int ct = ci4.x >= 0 ? ci4.x : 0;  // a real atom has a type
          float a = __ldg(arow + ct);
          float b = __ldg(arow + T + ct);
          if (groups) {
            const float allowed = __ldg(grow + ci4.y);
            a = a * allowed;
            b = b * allowed;
          }
          const float qq = qrow * c.w;
          const float r2s = fmaxf(r2, 1e-10f);
          const float inv_r = rsqrtf(r2s);
          const float inv_r2 = inv_r * inv_r;
          const float r = r2s * inv_r;
          float erfc_br, gauss;
          coulomb(p, r, &erfc_br, &gauss);
          const float inv_r2_lj = 1.0f / fmaxf(r2, 1e-6f);
          const float inv_r6 = inv_r2_lj * inv_r2_lj * inv_r2_lj;
          const float inv_r12 = inv_r6 * inv_r6;
          float e_lj = a * a * inv_r12 - b * inv_r6;
          float f_lj =
              (12.0f * a * a * inv_r12 - 6.0f * b * inv_r6) * inv_r2_lj;
          if (p.r_switch > 0.f) {
            const float x = fminf(fmaxf((r - p.r_switch) * inv_w, 0.f), 1.f);
            const float x2 = x * x;
            const float sw = 1.0f + x * x2 * (-10.0f + x * (15.0f - 6.0f * x));
            const float dsw = x2 * (-30.0f + x * (60.0f - 30.0f * x)) * inv_w;
            f_lj = f_lj * sw - e_lj * dsw * inv_r;
            e_lj = e_lj * sw;
          }
          const float e_c = qq * erfc_br * inv_r;
          const float f_c = qq * (erfc_br * inv_r + gauss) * inv_r2;
          const float f_s = in_range ? f_lj + f_c : 0.f;
          fx += f_s * dx;
          fy += f_s * dy;
          fz += f_s * dz;
          elj += in_range ? e_lj : 0.f;
          ecoul += in_range ? e_c : 0.f;
        }
      }
    }
  }

  // 3. the warps' partials in warp order, then the excluded pairs
  float* part = s_part + warp * kParts * 32;
  part[lane] = fx;
  part[32 + lane] = fy;
  part[64 + lane] = fz;
  part[96 + lane] = elj;
  part[128 + lane] = ecoul;
  if (lane == 0) s_ev[warp] = n_eval;
  __syncthreads();
  if (warp != 0) return;
  fx = fy = fz = elj = ecoul = 0.f;
  for (int w = 0; w < S; ++w) {
    const float* pw = s_part + w * kParts * 32;
    fx += pw[lane];
    fy += pw[32 + lane];
    fz += pw[64 + lane];
    elj += pw[96 + lane];
    ecoul += pw[128 + lane];
  }
  if (lane == 0) {
    long long total = 0;
    for (int w = 0; w < S; ++w) total += s_ev[w];
    p.evals[rc] = total;
  }
  if (!row_real) return;
  float ecorr = 0.f;
  for (int d = -kMaxExcl; d <= kMaxExcl; ++d) {
    const int j = oid_r + d;
    if (d == 0 || j < 0 || j >= p.n) continue;
    const unsigned lower = d > 0 ? bits_r : (unsigned)p.bits[j];
    if (((lower >> (d > 0 ? d : -d)) & 1u) == 0u) continue;
    const float dx = min_image(px - p.pos[3 * j], L[0], iL[0]);
    const float dy = min_image(py - p.pos[3 * j + 1], L[1], iL[1]);
    const float dz = min_image(pz - p.pos[3 * j + 2], L[2], iL[2]);
    const float r2 = dx * dx + dy * dy + dz * dz;
    const float qq = qrow * p.q[j];
    const float r2s = fmaxf(r2, 1e-10f);
    const float inv_r = rsqrtf(r2s);
    const float inv_r2 = inv_r * inv_r;
    float erfc_br, gauss;
    coulomb(p, r2s * inv_r, &erfc_br, &gauss);
    const float erf_inv_r = (1.0f - erfc_br) * inv_r;
    const float f_x = -qq * (erf_inv_r - gauss) * inv_r2;
    fx += f_x * dx;
    fy += f_x * dy;
    fz += f_x * dz;
    ecorr += -qq * erf_inv_r;
  }
  float4* o = reinterpret_cast<float4*>(p.fout + (size_t)oid_r * 8);
  o[0] = make_float4(fx, fy, fz, elj);
  o[1] = make_float4(ecoul, ecorr, 0.f, 0.f);
}

}  // namespace

extern "C" {

// Launches the sweep on `stream` over a sorted layout of n_c chunks;
// returns cudaGetLastError() of the launch (0 on success).
int rect_pair_launch(const float* pos, const float* q, const float* ab,
                     int ab_w, int t_dim, const int* ctype, const int* cgroup,
                     const float* grows, int g_dim, const int* bits,
                     const float* box, const int* oid, const float* cbox,
                     int n_c, int n_pad, int n, float beta,
                     float rc2, float skip_r2, float r_cutoff, float r_switch,
                     float gauss_pref, float* fout, long long* evals,
                     void* stream) {
  if (n_pad < 0 || n < 0 || n > n_pad || t_dim < 1 || ab_w < 2 * t_dim ||
      n_c != (n + 31) / 32)
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
  p.oid = oid;
  p.cbox = reinterpret_cast<const float4*>(cbox);
  p.fout = fout;
  p.evals = evals;
  p.ab_w = ab_w;
  p.t_dim = t_dim;
  p.g_dim = g_dim;
  p.n_pad = n_pad;
  p.n = n;
  p.n_c = n_c;
  p.beta = beta;
  p.rc2 = rc2;
  p.skip_r2 = skip_r2;
  p.r_cutoff = r_cutoff;
  p.r_switch = r_switch;
  p.gauss_pref = gauss_pref;
  const int smem = ((n_c + 31) / 32) * (int)sizeof(unsigned);
  if (kStaticSmem + smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rect_pair_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = n_c > 0 ? n_c : 1;
  rect_pair_kernel<<<blocks, kWarps * 32, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

const char* rect_pair_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
