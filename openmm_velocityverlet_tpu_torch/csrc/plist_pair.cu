// Kernel B1: the AABB-culled tile-pair-list nonbonded sweep, for Hopper.
//
// Replaces openmm_velocityverlet_tpu/ops/pallas_pair.py:_plist_kernel
// (launched by _run_plist).  Computes, for every active entry of the packed
// pair list (word = row_tile<<17 | col_tile<<3 | flags; bit0 active, bit1
// has-exclusions; sorted by row tile, row_ptr[t] .. row_ptr[t+1] the entries
// of row tile t), the LJ + Ewald direct-space + exclusion-correction
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
//     on diagonal tiles.  Excluded pairs get -qq erf(beta r)/r, whatever
//     their distance.
// Outputs keep the JAX layout: rows (n_tiles*ts, 8) = fx,fy,fz,e_lj,
// e_coul,e_corr,0,0 and colacc (8, n_pad) with the Newton reaction of
// off-diagonal tiles in rows 0..2.
//
// Bound: operations.  The function needs ~70 FP32 operations for each pair
// within the cutoff; the bytes (positions and per-atom columns once, the
// list, the outputs) are small next to that.  What a kernel loses against
// the bound is (a) pairs it evaluates beyond the cutoff, because a tile is a
// box of atoms and not a sphere, and (b) instructions per pair beside the
// arithmetic.  The design is for a card whose unit is a 32-thread warp.
//
// Design.
//   * The unit of work is 32 rows x 32 columns.  A warp holds 32 row atoms
//     of the row tile in registers (one per lane), in a frame of their own:
//     on a nowrap axis the tile's first atom, else the chunk's first atom.
//     ts is any multiple of 32 from 32 to 384; ts = 32 makes a tile one
//     such chunk.
//   * Column skip.  Each lane loads one column atom, wraps it next to the
//     centre of the row chunk's bounding box and tests its periodic distance
//     to that box (grown by 0.001 nm for float32 rounding) against the
//     cutoff; __ballot_sync gives the warp the mask of columns that some row
//     may reach, and the pair loop visits only the set bits.  Every lane
//     meets the same column at a step (a broadcast read from shared memory),
//     so the skip costs no divergence.  The distance to the box bounds the
//     distance to every row from below on both kinds of axis, so no pair
//     inside the cutoff is dropped.  A pair excluded by the offset mask has
//     original indices at most 31 apart: on an entry whose has-exclusions
//     flag is set (the flag is exact), a column whose index lies within 31 of
//     the row chunk's index range is never skipped.  Pad columns (type -1)
//     contribute nothing and are skipped.
//   * Minimum image once a column.  On a wrapped axis the column sits
//     within half a box of the chunk's centre; when the chunk's half extent
//     is below L/2 - cutoff (and the entry has no exclusions, whose pairs
//     may lie anywhere) the plain difference is the minimum image for every
//     pair inside the cutoff, and the per-pair rintf is left out.  An entry
//     with exclusions takes rows and columns as stored and the per-pair
//     minimum image, so that coincident atoms keep dx = 0 exactly.
//   * A block owns a slice of a row tile's entries (the list is sorted by
//     row tile; blk_tile / blk_e0 name each block's tile and first entry):
//     16 entries at ts = 32, 4 at 64, one from 96 on.  Its warps are (row
//     chunk, entry lane) pairs, entry lane l taking the slice's entries l,
//     l + L, ...  The row force stays in registers over all of a warp's
//     entries and is combined across the entry lanes once, in lane order,
//     through shared memory; the block writes one row partial.  Slices, not
//     whole tiles, because a pair is a chain of several hundred cycles for
//     the warp that evaluates it, and a tile with three times the mean
//     number of entries would hold the whole launch.
//   * The pair loop takes four columns a round: four independent chains
//     for the scheduler (a warp issues in order, and one pair is a chain of
//     ~300 cycles), and one reduction for their reactions.  A column's
//     reaction is the sum of its 32 pair forces over the lanes; a plain xor
//     butterfly would be 5 shuffles a component a column, on a pipe a
//     quarter as wide as the FP32 one.  Four columns are summed together by
//     a halving exchange (3 shuffles) and a butterfly over the remaining lane
//     bits (3): 1.5 shuffles a component a column, in a fixed order.  The
//     next item's column atoms are loaded while this one is computed.
//   * Each (entry, row chunk) writes its 3 x ts column partial; a second
//     kernel sums, per tile, the row partials of its slices and the column
//     partials of its entries, a few lanes in parallel and then in lane
//     order.  No float atomics anywhere: the result is bitwise equal
//     from run to run (checked on the card by chip_smoke.py and
//     tests/test_torch_kernels.py).
//   * The row chunk's LJ rows ([a, b] pairs and the group-allowed row) are
//     staged once a block in shared memory with an odd row stride, so the
//     lookup by the broadcast column type is one conflict-free shared read;
//     pad columns index a zero entry.  When the rows do not fit (large K),
//     that call reads them with __ldg instead.
//   * Tensor cores have no part here: the TPU kernel's only matrix product
//     was the one-hot LJ lookup, which is an index on this card; the rest is
//     FP32 arithmetic on r^2 that no MMA shape expresses.
//
// Rounding: positions wrap with rintf (round half to even, as jnp.round);
// 1/sqrt is rsqrtf (about 2 ulp from the JAX lax.rsqrt), nvcc contracts
// multiply-adds into FMAs, and a column pre-wrapped next to the row chunk
// differs in its last bit from a per-pair minimum image, so the kernel
// agrees with its plain torch version to float32 rounding, not bitwise.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxTs = 384;
constexpr int kNCoef = 11;
constexpr float kOne4PiEps0 = 138.935456f;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kBoxSlack = 1e-3f;    // nm added to the row box's half extent
constexpr int kMaxSmem = 100 * 1024;  // dynamic shared memory a block may ask

struct Params {
  const int* plist;
  const int* row_ptr;   // (n_tiles + 1,)
  const int* blk_tile;  // (n_blocks,) row tile of each block, -1 for none
  const int* blk_e0;    // (n_blocks,) first entry of each block's slice
  const float* pos;     // (n_pad, 3) sorted
  const float* q;       // (n_pad,)
  const float* ab2;     // (stack * n_pad, K) tile-major stacked LJ rows
  const int* ctype;     // (n_pad,) LJ type, -1 for pad atoms
  const int* cgroup;    // (n_pad,) interaction group
  const int* bits;      // (n_pad,) exclusion masks
  const int* oid;       // (n_pad,) original atom indices
  const float* box;     // (3,)
  float* prow;          // (n_blocks, 6, ts) per-slice row partials
  float* pcol;          // (cap, ts/32, 3, ts) per (entry, row chunk) partials
  unsigned long long* evals;  // optional: pair evaluations made, else null
  int ts, K, Kp, t_dim, stack, nowrap, nrc, epw, slice;
  float beta, rc2, r_cutoff, r_switch, cap3, gauss_pref;
  float pc[kNCoef];
};

__device__ __forceinline__ float wrap_frame(float a, float c0, float L,
                                            float iL) {
  return a - L * rintf((a - c0) * iL);
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

constexpr int kBatch = 4;  // columns a round of the pair loop

// Sum over the 32 lanes of slot (lane % 4) of v: a halving exchange over the
// two low lane bits (3 shuffles, each lane keeping the half of the slots its
// bit selects), then a butterfly over the other bits.  Fixed order;
// a + b == b + a bitwise, so lanes with the same slot end equal.
__device__ __forceinline__ float batch_sum(const float (&v)[kBatch],
                                           int lane) {
  static_assert(kBatch == 4, "batch_sum: 4 slots");
  const bool h1 = lane & 1, h2 = lane & 2;
  const float a0 =
      (h2 ? v[2] : v[0]) + __shfl_xor_sync(kFull, h2 ? v[0] : v[2], 2);
  const float a1 =
      (h2 ? v[3] : v[1]) + __shfl_xor_sync(kFull, h2 ? v[1] : v[3], 2);
  float b = (h1 ? a1 : a0) + __shfl_xor_sync(kFull, h1 ? a0 : a1, 1);
  b += __shfl_xor_sync(kFull, b, 4);
  b += __shfl_xor_sync(kFull, b, 8);
  b += __shfl_xor_sync(kFull, b, 16);
  return b;
}

struct ColAtom {
  float x, y, z, q;
  int t, g, b, o;
};

__device__ __forceinline__ ColAtom load_col(const Params& p, int cj) {
  ColAtom c;
  c.x = p.pos[3 * cj];
  c.y = p.pos[3 * cj + 1];
  c.z = p.pos[3 * cj + 2];
  c.q = p.q[cj];
  c.t = p.ctype[cj];
  c.g = p.cgroup[cj];
  c.b = p.bits[cj];
  c.o = p.oid[cj];
  return c;
}

// Dynamic shared memory: per warp 32 column atoms as float4 (x, y, z, q),
// int (type | group index << 16) and int2 (bits, oid), and 6 x 32 row
// partials; then the block's LJ rows when LjShared.
template <bool WantEnergy, bool LjShared, int MaxThreads>
__global__ void __launch_bounds__(MaxThreads, MaxThreads <= 256 ? 2 : 1)
plist_pair_kernel(Params p) {
  extern __shared__ float4 smem4[];
  const int nwarps = blockDim.x >> 5;
  float4* s_c4 = smem4;
  int2* s_bo = reinterpret_cast<int2*>(s_c4 + nwarps * 32);
  int* s_tg = reinterpret_cast<int*>(s_bo + nwarps * 32);
  float* s_red = reinterpret_cast<float*>(s_tg + nwarps * 32);
  float2* s_ab = reinterpret_cast<float2*>(s_red + nwarps * 6 * 32);
  float* s_g = reinterpret_cast<float*>(s_ab + (LjShared ? p.ts * p.Kp : 0));

  const int t = p.blk_tile[blockIdx.x];   // the row tile
  if (t < 0) return;
  const int ts = p.ts;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rc = warp % p.nrc;            // row chunk of the tile
  const int el = warp / p.nrc;            // entry lane
  const int wb = warp * 32;
  const int K = p.K, Kp = p.Kp;
  const bool groups = p.stack == 3;

  if (LjShared) {
    const float* A = p.ab2 + (size_t)(p.stack * t) * ts * K;
    const float* B = A + (size_t)ts * K;
    const float* G = B + (size_t)ts * K;
    for (int i = threadIdx.x; i < ts * Kp; i += blockDim.x) {
      const int r = i / Kp, c = i - r * Kp;
      const bool in = c < K;
      s_ab[i] = in ? make_float2(A[r * K + c], B[r * K + c])
                   : make_float2(0.f, 0.f);
      if (groups) s_g[i] = in ? G[r * K + c] : 0.f;
    }
  }

  const float bx = p.box[0], by = p.box[1], bz = p.box[2];
  const float ibx = 1.0f / bx, iby = 1.0f / by, ibz = 1.0f / bz;
  const bool nwx = p.nowrap & 1, nwy = p.nowrap & 2, nwz = p.nowrap & 4;
  const int lrow = rc * 32 + lane;        // row inside the tile
  const int row = t * ts + lrow;
  // the row as stored, for entries with exclusions on wrapped axes: a pair
  // of coincident atoms (a Drude particle on its core) must keep dx = 0
  // exactly, as the energy form's excluded-pair force divides by r^2
  const float pxr = p.pos[3 * row], pyr = p.pos[3 * row + 1],
              pzr = p.pos[3 * row + 2];
  float px = pxr, py = pyr, pz = pzr;
  {
    // the frame: the tile's first atom on a nowrap axis (the list's
    // contract), else the chunk's first atom
    const int r0 = t * ts;
    const float fx0 = nwx ? p.pos[3 * r0] : __shfl_sync(kFull, px, 0);
    const float fy0 = nwy ? p.pos[3 * r0 + 1] : __shfl_sync(kFull, py, 0);
    const float fz0 = nwz ? p.pos[3 * r0 + 2] : __shfl_sync(kFull, pz, 0);
    px = wrap_frame(px, fx0, bx, ibx);
    py = wrap_frame(py, fy0, by, iby);
    pz = wrap_frame(pz, fz0, bz, ibz);
  }
  // the nowrap frame of a column: the tile's first atom, as the rows'
  const float c0x = p.pos[3 * t * ts], c0y = p.pos[3 * t * ts + 1],
              c0z = p.pos[3 * t * ts + 2];
  // bounding box of the row chunk: centre and half extent (grown)
  const float lox = warp_min(px), hix = warp_max(px);
  const float loy = warp_min(py), hiy = warp_max(py);
  const float loz = warp_min(pz), hiz = warp_max(pz);
  const float mx = 0.5f * (lox + hix), hx = 0.5f * (hix - lox) + kBoxSlack;
  const float my = 0.5f * (loy + hiy), hy = 0.5f * (hiy - loy) + kBoxSlack;
  const float mz = 0.5f * (loz + hiz), hz = 0.5f * (hiz - loz) + kBoxSlack;
  // a wrapped axis needs the per-pair minimum image unless the chunk is
  // narrow enough (see the note above)
  const bool widex = !nwx && !(hx < 0.5f * bx - p.r_cutoff);
  const bool widey = !nwy && !(hy < 0.5f * by - p.r_cutoff);
  const bool widez = !nwz && !(hz < 0.5f * bz - p.r_cutoff);
  const float rc2_skip = p.rc2 * 1.0001f;

  const float qrow = kOne4PiEps0 * p.q[row];
  const int bits_r = p.bits[row];
  const int oid_r = p.oid[row];
  int omin = oid_r, omax = oid_r;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    omin = min(omin, __shfl_xor_sync(kFull, omin, o));
    omax = max(omax, __shfl_xor_sync(kFull, omax, o));
  }
  const float* arow = p.ab2 + (size_t)((p.stack * t) * ts + lrow) * K;
  const float* brow = p.ab2 + (size_t)((p.stack * t + 1) * ts + lrow) * K;
  const float* grow = p.ab2 + (size_t)((p.stack * t + 2) * ts + lrow) * K;
  const float2* s_abrow = s_ab + lrow * Kp;
  const float* s_grow = s_g + lrow * Kp;
  if (LjShared) __syncthreads();

  float fx = 0.f, fy = 0.f, fz = 0.f;
  float elj = 0.f, ecoul = 0.f, ecorr = 0.f;
  unsigned long long n_eval = 0;
  const int ncc = p.nrc;                  // column chunks of a tile
  float* gcol = s_red + warp * 6 * 32;    // the item's column sums, 3 x 32
  const int e0 = p.blk_e0[blockIdx.x] + el;
  const int e_end = min(p.blk_e0[blockIdx.x] + p.slice, p.row_ptr[t + 1]);
  const int n_items =
      e0 < e_end ? ((e_end - e0 + p.epw - 1) / p.epw) * ncc : 0;
  // the next item's column atom is loaded while this one is computed
  int word_n = 0;
  ColAtom nxt = {};
  if (n_items > 0) {
    word_n = p.plist[e0];
    nxt = load_col(p, ((word_n >> 3) & 0x3FFF) * ts + lane);
  }
  for (int it = 0; it < n_items; ++it) {
    const int ei = it / ncc, cc = it - ei * ncc;
    const int e = e0 + ei * p.epw;
    const int word = word_n;
    const ColAtom ca = nxt;
    if (it + 1 < n_items) {
      const int ei2 = (it + 1) / ncc, cc2 = it + 1 - ei2 * ncc;
      if (cc2 == 0) word_n = p.plist[e0 + ei2 * p.epw];
      nxt = load_col(p, ((word_n >> 3) & 0x3FFF) * ts + cc2 * 32 + lane);
    }
    if ((word & 1) == 0 || (word >> 17) != t) continue;  // uniform
    const int tj = (word >> 3) & 0x3FFF;
    const bool flagged = (word & 2) != 0;
    const bool test_excl = WantEnergy || flagged;
    const bool diag = tj == t;
    // an entry with exclusions: rows and columns as stored and the
    // per-pair minimum image (an excluded pair is corrected at any
    // distance, and coincident atoms must keep dx = 0)
    const bool rawx = flagged && !nwx, rawy = flagged && !nwy,
               rawz = flagged && !nwz;
    const bool ppx = widex || rawx, ppy = widey || rawy, ppz = widez || rawz;
    const float rx = rawx ? pxr : px, ry = rawy ? pyr : py,
                rz = rawz ? pzr : pz;
    float cx = ca.x, cy = ca.y, cz = ca.z;
    // the column next to the row box's centre (nowrap: in the tile's
    // frame first, as the list's contract has it)
    if (nwx) cx = wrap_frame(cx, c0x, bx, ibx);
    if (nwy) cy = wrap_frame(cy, c0y, by, iby);
    if (nwz) cz = wrap_frame(cz, c0z, bz, ibz);
    float ux = cx - mx, uy = cy - my, uz = cz - mz;
    ux -= bx * rintf(ux * ibx);
    uy -= by * rintf(uy * iby);
    uz -= bz * rintf(uz * ibz);
    if (!nwx && !rawx) cx = mx + ux;
    if (!nwy && !rawy) cy = my + uy;
    if (!nwz && !rawz) cz = mz + uz;
    const float gpx = fmaxf(fabsf(ux) - hx, 0.f);
    const float gpy = fmaxf(fabsf(uy) - hy, 0.f);
    const float gpz = fmaxf(fabsf(uz) - hz, 0.f);
    bool keep = gpx * gpx + gpy * gpy + gpz * gpz <= rc2_skip;
    if (flagged) keep = keep || (ca.o >= omin - 31 && ca.o <= omax + 31);
    keep = keep && ca.t >= 0;
    unsigned mask = __ballot_sync(kFull, keep);
    float* dst =
        p.pcol + ((size_t)(e * p.nrc + rc) * 3) * ts + cc * 32 + lane;
    if (mask == 0) {
      if (!diag) {
        dst[0] = 0.f;
        dst[ts] = 0.f;
        dst[2 * ts] = 0.f;
      }
      continue;
    }
    __syncwarp();
    s_c4[wb + lane] = make_float4(cx, cy, cz, ca.q);
    s_tg[wb + lane] = (ca.t < 0 ? K : ca.t) | ((p.t_dim + ca.g) << 16);
    if (test_excl) s_bo[wb + lane] = make_int2(ca.b, ca.o);
    if (!diag) {
      gcol[lane] = 0.f;
      gcol[32 + lane] = 0.f;
      gcol[64 + lane] = 0.f;
    }
    __syncwarp();
    float eelj = 0.f, eecoul = 0.f, eecorr = 0.f;
    while (mask != 0) {
      // kBatch columns a round: independent chains for the scheduler, and
      // one transposed reduction for their reactions
      int jb[kBatch];
      float vx[kBatch], vy[kBatch], vz[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        jb[u] = mask != 0 ? __ffs(mask) - 1 : -1;
        mask &= mask - 1;
      }
      n_eval += 32ull * kBatch;
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const bool live = jb[u] >= 0;  // an empty slot computes column 0 for
        const int j = live ? jb[u] : 0;  // nothing
        const float4 c = s_c4[wb + j];
        float dx = rx - c.x;
        float dy = ry - c.y;
        float dz = rz - c.z;
        if (ppx) dx = dx - bx * rintf(dx * ibx);
        if (ppy) dy = dy - by * rintf(dy * iby);
        if (ppz) dz = dz - bz * rintf(dz * ibz);
        const float r2 = dx * dx + dy * dy + dz * dz;

        bool excl = false, alive = live;
        if (test_excl) {
          const int2 bo = s_bo[wb + j];
          const int delta = bo.y - oid_r;
          const int bits_lo = delta >= 0 ? bits_r : bo.x;
          const int dabs = delta >= 0 ? delta : -delta;
          const int dsh = dabs < 31 ? dabs : 31;  // a shift >= 32 is undefined
          excl = ((((unsigned)bits_lo) >> dsh) & 1u) && dabs <= 31;
          alive = live && delta != 0;
          excl = excl && alive;
        }
        const int tg = s_tg[wb + j];
        const int ctj = tg & 0xffff;
        float a, b;
        if (LjShared) {
          const float2 ab = s_abrow[ctj];
          a = ab.x;
          b = ab.y;
          if (groups) {
            const float allowed = s_grow[tg >> 16];
            a = a * allowed;
            b = b * allowed;
          }
        } else {
          a = 0.f;
          b = 0.f;
          if (ctj < K) {
            a = __ldg(arow + ctj);
            b = __ldg(brow + ctj);
            if (groups) {
              const float allowed = __ldg(grow + (tg >> 16));
              a = a * allowed;
              b = b * allowed;
            }
          }
        }
        const float qq = qrow * c.w;

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
          const float tt = 1.0f / (1.0f + 0.3275911f * br);
          const float erfc_br =
              (tt * (0.254829592f +
                     tt * (-0.284496736f +
                           tt * (1.421413741f +
                                 tt * (-1.453152027f + tt * 1.061405429f))))) *
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
          for (int k = kNCoef - 2; k >= 0; --k) pp = pp * r2s + p.pc[k];
          const float w = qq * pp;
          f_c = qq * fminf(inv_r * inv_r2, p.cap3) + w;
          f_x = w;
        }
        const bool in_range = alive && !excl && (r2 < p.rc2);
        const bool corr = alive && excl;
        const float f_s = (in_range ? f_lj + f_c : 0.f) + (corr ? f_x : 0.f);
        vx[u] = f_s * dx;
        vy[u] = f_s * dy;
        vz[u] = f_s * dz;
        fx += vx[u];
        fy += vy[u];
        fz += vz[u];
        if (WantEnergy) {
          if (in_range) {
            eelj += e_lj;
            eecoul += e_c;
          }
          if (corr) eecorr += e_x;
        }
      }
      if (!diag) {
        // the columns' reactions: lane l ends with the sum over the 32 rows
        // of slot l % kBatch; the first kBatch lanes store them
        const float sx = batch_sum(vx, lane);
        const float sy = batch_sum(vy, lane);
        const float sz = batch_sum(vz, lane);
        int js = jb[0];
#pragma unroll
        for (int u = 1; u < kBatch; ++u)
          if ((lane & (kBatch - 1)) == u) js = jb[u];
        if (lane < kBatch && js >= 0) {
          gcol[js] = -sx;
          gcol[32 + js] = -sy;
          gcol[64 + js] = -sz;
        }
      }
    }
    if (!diag) {
      __syncwarp();
      dst[0] = gcol[lane];
      dst[ts] = gcol[32 + lane];
      dst[2 * ts] = gcol[64 + lane];
    }
    if (WantEnergy) {
      const float half = diag ? 0.5f : 1.0f;
      elj += half * eelj;
      ecoul += half * eecoul;
      ecorr += half * eecorr;
    }
  }

  __syncwarp();  // the warp's column sums share s_red with its row partials
  // combine the entry lanes of each row chunk in lane order
  float* red = s_red + warp * 6 * 32 + lane;
  red[0] = fx;
  red[32] = fy;
  red[64] = fz;
  red[96] = elj;
  red[128] = ecoul;
  red[160] = ecorr;
  __syncthreads();
  if (el == 0) {
    float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int l = 0; l < p.epw; ++l) {
      const float* src = s_red + (l * p.nrc + rc) * 6 * 32 + lane;
#pragma unroll
      for (int c = 0; c < 6; ++c) acc[c] += src[c * 32];
    }
    float* dst = p.prow + (size_t)blockIdx.x * 6 * ts + lrow;
#pragma unroll
    for (int c = 0; c < (WantEnergy ? 6 : 3); ++c) dst[c * ts] = acc[c];
  }
  if (p.evals != nullptr && lane == 0 && n_eval != 0)
    atomicAdd(p.evals, n_eval);  // an integer count: order does not matter
}

// One block per tile, `lanes` threads per atom.  Lane l sums the row
// partials of the tile's slices blk_ptr[t] + l, + lanes, ... and the column
// partials of entries col_idx[col_ptr[t] + l], + lanes, ... (each with its
// row chunks ascending); the lanes are then added in lane order through
// shared memory (lanes x 9 x ts floats).  Fixed order.
__global__ void __launch_bounds__(kMaxTs)
plist_reduce_kernel(const float* prow, const float* pcol, const int* blk_ptr,
                    const int* col_ptr, const int* col_idx, int ts, int nrc,
                    int lanes, int n_pad, int n_row_vals, float* rows,
                    float* colacc) {
  extern __shared__ float s_part[];
  const int t = blockIdx.x;
  const int r = threadIdx.x % ts;
  const int l = threadIdx.x / ts;
  const size_t ts_ = (size_t)ts;
  float acc[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  const int s_end = blk_ptr[t + 1];
  for (int b = blk_ptr[t] + l; b < s_end; b += lanes) {
    const float* src = prow + (size_t)b * 6 * ts_ + r;
    for (int c = 0; c < n_row_vals; ++c) acc[c] += src[c * ts_];
  }
  const int k_end = col_ptr[t + 1];
  for (int k = col_ptr[t] + l; k < k_end; k += lanes) {
    const float* src = pcol + (size_t)col_idx[k] * nrc * 3 * ts_ + r;
    for (int c = 0; c < nrc; ++c, src += 3 * ts_) {
      acc[6] += src[0];
      acc[7] += src[ts_];
      acc[8] += src[2 * ts_];
    }
  }
  float* mine = s_part + (size_t)l * 9 * ts_ + r;
  for (int c = 0; c < 9; ++c) mine[c * ts_] = acc[c];
  __syncthreads();
  if (l != 0) return;
  for (int c = 0; c < 9; ++c) acc[c] = 0.f;
  for (int k = 0; k < lanes; ++k) {
    const float* src = s_part + (size_t)k * 9 * ts_ + r;
    for (int c = 0; c < 9; ++c) acc[c] += src[c * ts_];
  }
  const size_t col = (size_t)t * ts_ + r;
  float4* dst = reinterpret_cast<float4*>(rows + col * 8);
  dst[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  dst[1] = make_float4(acc[4], acc[5], 0.f, 0.f);
  for (int c = 0; c < 8; ++c)
    colacc[c * (size_t)n_pad + col] = c < 3 ? acc[6 + c] : 0.f;
}

template <bool WantEnergy, bool LjShared, int MaxThreads>
cudaError_t launch_pair(const Params& p, int n_blocks, int threads, int smem,
                        cudaStream_t st) {
  static bool raised = false;  // once a process: allow more than 48 KB
  if (!raised) {
    cudaError_t err = cudaFuncSetAttribute(
        plist_pair_kernel<WantEnergy, LjShared, MaxThreads>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return err;
    raised = true;
  }
  plist_pair_kernel<WantEnergy, LjShared, MaxThreads>
      <<<n_blocks, threads, smem, st>>>(p);
  return cudaGetLastError();
}

template <bool WantEnergy, bool LjShared>
cudaError_t launch_pair_sized(const Params& p, int n_blocks, int threads,
                              int smem, cudaStream_t st) {
  return threads <= 256
             ? launch_pair<WantEnergy, LjShared, 256>(p, n_blocks, threads,
                                                      smem, st)
             : launch_pair<WantEnergy, LjShared, kMaxTs>(p, n_blocks, threads,
                                                         smem, st);
}

}  // namespace

extern "C" {

// Launches the pair kernel and the reduction on `stream`; returns
// cudaGetLastError() of the launches (0 on success).  blk_tile, blk_e0
// (n_blocks,) and blk_ptr (n_tiles + 1,) cut each row tile's entries into
// slices of `slice` entries (ops/pair_plist.py:slice_blocks).  `evals`, when
// not null, is a device counter the kernel adds its pair evaluations to.
int plist_pair_launch(const int* plist, int cap, const float* pos,
                      const float* q, const float* ab2, int K, int t_dim,
                      int stack, const int* ctype, const int* cgroup,
                      const int* bits, const int* oid, const float* box,
                      int n_pad, int ts, float beta, float rc2,
                      float r_cutoff, float r_switch, float cap3,
                      float gauss_pref, const float* pcoef, int nowrap,
                      int want_energy, const int* row_ptr, const int* col_ptr,
                      const int* col_idx, const int* blk_tile,
                      const int* blk_e0, const int* blk_ptr, int n_blocks,
                      int slice, float* prow, float* pcol, float* rows,
                      float* colacc,
                      unsigned long long* evals, void* stream) {
  if (ts <= 0 || ts > kMaxTs || ts % 32 != 0 || n_pad % ts != 0 || K <= 0 ||
      K >= 0xffff || cap < 0 || n_blocks < 0 || slice < 1)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.plist = plist;
  p.row_ptr = row_ptr;
  p.blk_tile = blk_tile;
  p.blk_e0 = blk_e0;
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
  p.evals = evals;
  p.ts = ts;
  p.K = K;
  p.Kp = (K + 1) | 1;  // odd, and one zero entry for pad columns
  p.t_dim = t_dim;
  p.stack = stack;
  p.nowrap = nowrap;
  p.nrc = ts / 32;
  p.slice = slice;
  // entry lanes: up to 8 warps a block, no more lanes than entries
  p.epw = 8 / p.nrc > 0 ? 8 / p.nrc : 1;
  if (p.epw > p.slice) p.epw = p.slice;
  p.beta = beta;
  p.rc2 = rc2;
  p.r_cutoff = r_cutoff;
  p.r_switch = r_switch;
  p.cap3 = cap3;
  p.gauss_pref = gauss_pref;
  for (int c = 0; c < kNCoef; ++c) p.pc[c] = pcoef[c];
  const int warps = p.nrc * p.epw;
  const int n_tiles = n_pad / ts;
  // per warp: float4 + int2 + int columns and 6 row partials, 32 lanes each
  const int smem_base = warps * 32 * (16 + 8 + 4 + 6 * 4);
  const long long smem_lj =
      (long long)ts * p.Kp * (stack == 3 ? 12 : 8);
  const bool lj_shared = smem_base + smem_lj <= kMaxSmem;
  const int smem = smem_base + (lj_shared ? (int)smem_lj : 0);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaSuccess;
  if (n_blocks > 0) {
    const int th = warps * 32;
    if (want_energy)
      err = lj_shared
                ? launch_pair_sized<true, true>(p, n_blocks, th, smem, st)
                : launch_pair_sized<true, false>(p, n_blocks, th, smem, st);
    else
      err = lj_shared
                ? launch_pair_sized<false, true>(p, n_blocks, th, smem, st)
                : launch_pair_sized<false, false>(p, n_blocks, th, smem, st);
  }
  if (err != cudaSuccess) return (int)err;
  const int lanes = ts >= 256 ? 1 : 256 / ts;
  plist_reduce_kernel<<<n_tiles, ts * lanes, lanes * 9 * ts * sizeof(float),
                        st>>>(prow, pcol, blk_ptr, col_ptr, col_idx, ts,
                              p.nrc, lanes, n_pad, want_energy ? 6 : 3, rows,
                              colacc);
  return (int)cudaGetLastError();
}

const char* plist_pair_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
