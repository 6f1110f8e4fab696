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
// Both kernels here use what the list is: the integer lattice nx in
// [-kmx, kmx], ny in [-kmy, kmy], nz in [0, kmz] in C order with nz fastest,
// less the non-canonical half of the nz = 0 plane (ops/ewald_fused.py:
// _half_space_modes).  So e^{i k.r} = ex[nx] ey[ny] ez[nz], and an atom needs
// a few dozen sincosf, not one a mode.
//
// B4 is the contraction S(nx, ny, nz) = sum_i (q_i ex_i[nx] ey_i[ny])
// ez_i[nz]: for each nx a complex (ny x atoms) . (atoms x nz) product, four
// multiply-adds a phase and no special function.  The sum runs over atoms,
// so a thread owns outputs: a register tile of 4 ny x 7 nz complex sums of
// one nx (56 registers), and its block walks a range of atoms.
//   * phase_table_kernel writes every atom's axis tables once a call, one
//     direct sincosf an entry with k_n = (2 pi n) / L rounded exactly as the
//     list's kvec (no running product, so no error grows along a table; the
//     rounding of the product k_n x is carried to first order),
//     negative n the conjugate: about 2 kmx + 2 kmy + kmz entries an atom
//     (106 at kmax 20), already signed, padded with zeros to whole tiles and
//     with q folded into the x table, so the main kernel only copies them.
//   * structure_tile_kernel.  The flattened (nx, group of 4 ny) axis is cut
//     into "slots"; a block takes sb slots (a multiple of 32) and all nz
//     groups, thread = (nz group, slot) with the slot fastest, so the lanes
//     of a warp share their nz group.  For 32 atoms at a time the block
//     copies its rows of the tables into shared memory (two barriers for 32
//     atoms).  In the loop a thread reads q ex of its nx (a few addresses a
//     warp), its four ey as two 16-byte words (rows of odd stride: no bank
//     conflict) and its 7 ez (one address a warp: a broadcast), forms
//     A = q ex ey (16 operations, 1/14 of the loop's) and does 112
//     multiply-adds: 11 FMAs to a shared read.  grid.y cuts the atoms into a
//     fixed number of ranges, chosen from the shapes and the SM count (two
//     blocks an SM, which overlap one block's copy with the other's loop).
//   * structure_reduce_kernel adds the ranges' partial blocks element by
//     element in ascending range order and writes each sum to its place in
//     the list (a host-built map; the half plane the list lacks is dropped,
//     and the pad modes k >= K take the (0, 0, 0) element, sum_i q_i, which
//     is what the plain version gives at kvec = 0).
// No atomics: bitwise equal from run to run.
//
// B5 turns the same factorisation round: one thread an atom, 128 atoms a
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
// Bound: operations.  B4 takes 8 FP32 operations a phase (four
// multiply-adds) and B5 12, neither a special function in its loop (a table
// entry's argument reaches 2 pi kmax ~ 126 rad at kmax 20, where the fast
// __sincosf intrinsic loses its accuracy, so the tables take sincosf); the
// bytes moved are O(N + K) plus the tables and the partials (B4 at 19,500
// atoms: 17 MB of tables and 17 MB of partials, small enough to stay in the
// 50 MB L2).  The factorised phase is the
// product of three factors whose arguments are each rounded once, where the
// direct form rounds the three-term sum k.r at up to 126 rad: it is no less
// exact than the plain version.
//
// Tensor cores: both are small matrix products (B4 over atoms, B5 over nz),
// but TF32 keeps three decimal digits and the reciprocal sum cancels to
// about 1e-6 of its terms (ops/ewald.py says why it needs float32), so both
// kernels stay on the FP32 pipes.

#include <cuda_runtime.h>

namespace {

constexpr int kTileY = 4;         // B4: ny modes of a thread's tile
constexpr int kTileZ = 7;         // B4: nz modes of a thread's tile
constexpr int kStageAtoms = 32;   // B4: atoms staged at a time
constexpr int kMaxTileThreads = 320;  // B4: threads a block, two blocks an SM
constexpr int kForceThreads = 128;  // B5: atoms per block
constexpr int kNyBlock = 4;       // B5: ny columns a thread takes at a time
constexpr int kMaxSmem = 227 * 1024;
constexpr float kTwoPi = 6.2831855f;  // float32(2 pi), as the k list's

// The k value of mode n on an axis of length L, in the list's own rounding
// (ops/ewald_fused.py:_prep).
__device__ __forceinline__ float axis_k(int n, float L) {
  return (kTwoPi * (float)n) / L;
}

struct TileParams {
  const float* pos;    // (n_pad, 3)
  const float* q;      // (n_pad,)
  const float* box;    // (3,)
  float* tab;          // the tables, see phase_table_kernel
  float2* part;        // (ranges, nzg * 7 * 4 * stot)
  int kmx, kmy, kmz, n_pad;
  int n_tab;           // atoms of a table row: n_pad rounded up to 32
  int sb;              // slots a block
  int nyg, nzg;        // groups of 4 ny, of 7 nz
  int stot;            // slots of all blocks (gridDim.x * sb)
  int atoms_per;       // atoms a range (a multiple of kStageAtoms)
  int nxr;             // nx values a block's slots can touch
  int nxp;             // x rows of the table
};

// The three tables of a call, each row n_tab atoms long:
//   x: nxp rows of float2, q (cos, sin)(k_nx x) for nx = row - kmx, zero
//      beyond kmx (rows that only pad slots touch);
//   z: nzg * 7 rows of float2, (cos, sin)(k_nz z), zero beyond kmz;
//   y: 2 nyg rows of float4, row g the modes ny = 4 g - kmy and the next as
//      (cos, sin, cos, sin), row nyg + g the two after, zero beyond kmy.
// Negative n is the conjugate.  An atom of the padding (>= n_pad) is zero.
__device__ __forceinline__ float* table_x(const TileParams& p) { return p.tab; }
__device__ __forceinline__ float* table_z(const TileParams& p) {
  return p.tab + (size_t)2 * p.nxp * p.n_tab;
}
__device__ __forceinline__ float* table_y(const TileParams& p) {
  return p.tab + (size_t)2 * (p.nxp + p.nzg * kTileZ) * p.n_tab;
}

// One thread an (atom, table entry): one direct sincosf.
__global__ void phase_table_kernel(TileParams p) {
  const int atom = blockIdx.x * blockDim.x + threadIdx.x;
  if (atom >= p.n_tab) return;
  const int nzp = p.nzg * kTileZ;
  int e = blockIdx.y, axis, n, km;
  float2* dst;
  if (e < p.nxp) {
    axis = 0, n = e - p.kmx, km = p.kmx;
    dst = reinterpret_cast<float2*>(table_x(p)) + (size_t)e * p.n_tab + atom;
  } else if (e < p.nxp + nzp) {
    e -= p.nxp;
    axis = 2, n = e, km = p.kmz;
    dst = reinterpret_cast<float2*>(table_z(p)) + (size_t)e * p.n_tab + atom;
  } else {
    e -= p.nxp + nzp;
    axis = 1, n = e - p.kmy, km = p.kmy;
    const int g = e / kTileY, b = e - g * kTileY;
    dst = reinterpret_cast<float2*>(table_y(p)) +
          ((size_t)(b >> 1 ? p.nyg + g : g) * p.n_tab + atom) * 2 + (b & 1);
  }
  float2 v = make_float2(0.f, 0.f);
  if (atom < p.n_pad && n <= km) {
    // the argument k x reaches 126 rad at kmax 20, where one float32
    // rounding is 7.6e-6 rad, and on a lattice many atoms share an x and
    // with it that error; so the product's rounding residual (exact by fmaf)
    // is carried to first order
    const float k = axis_k(n < 0 ? -n : n, p.box[axis]);
    const float x = p.pos[3 * atom + axis];
    const float th = k * x;
    const float dth = fmaf(k, x, -th);
    float sn, cs;
    sincosf(th, &sn, &cs);
    v.x = fmaf(-dth, sn, cs);
    v.y = fmaf(dth, cs, sn);
    if (n < 0) v.y = -v.y;
    if (axis == 0) {
      const float qa = p.q[atom];
      v.x *= qa;
      v.y *= qa;
    }
  }
  *dst = v;
}

// Dynamic shared memory: y [2 nyg][kStageAtoms + 1] float4 (the odd stride
// keeps the lanes' 16-byte reads on distinct banks), x [nxr][kStageAtoms + 2]
// float2, z [nzg * 7][kStageAtoms] float2.
__global__ void __launch_bounds__(kMaxTileThreads, 2)
structure_tile_kernel(TileParams p) {
  extern __shared__ __align__(16) float4 smem_t[];
  constexpr int CA = kStageAtoms, SY = CA + 1, SX = CA + 2;
  const int sb = p.sb, nzp = p.nzg * kTileZ, nxr = p.nxr, nyg = p.nyg;
  float4* sY = smem_t;
  float2* sX = reinterpret_cast<float2*>(sY + 2 * nyg * SY);
  float2* sZ = sX + nxr * SX;
  const int tid = threadIdx.x;
  const int zg = tid / sb;            // the warp's nz group
  const int sl = tid - zg * sb;       // slot inside the block
  const int s = blockIdx.x * sb + sl;
  const int ix0 = (blockIdx.x * sb) / nyg;  // first x row of the block
  const int jx = s / nyg - ix0;             // this slot's x row in the block
  const int g = s - (s / nyg) * nyg;        // its group of 4 ny
  const float4* gY = reinterpret_cast<const float4*>(table_y(p));
  const float2* gX = reinterpret_cast<const float2*>(table_x(p)) +
                     (size_t)ix0 * p.n_tab;
  const float2* gZ = reinterpret_cast<const float2*>(table_z(p));
  const int a_begin = blockIdx.y * p.atoms_per;
  const int a_end = min(p.n_tab, a_begin + p.atoms_per);

  float2 acc[kTileY][kTileZ];
#pragma unroll
  for (int b = 0; b < kTileY; ++b)
#pragma unroll
    for (int z = 0; z < kTileZ; ++z) acc[b][z] = make_float2(0.f, 0.f);

  const float2* myX = sX + jx * SX;
  const float4* myLo = sY + g * SY;
  const float4* myHi = sY + (nyg + g) * SY;
  const float2* myZ = sZ + zg * kTileZ * CA;
  for (int a0 = a_begin; a0 < a_end; a0 += CA) {
    __syncthreads();  // the previous atoms are read out
    for (int i = tid; i < 2 * nyg * CA; i += blockDim.x) {
      const int row = i / CA, a = i - row * CA;
      sY[row * SY + a] = gY[(size_t)row * p.n_tab + a0 + a];
    }
    for (int i = tid; i < nxr * CA; i += blockDim.x) {
      const int row = i / CA, a = i - row * CA;
      sX[row * SX + a] = gX[(size_t)row * p.n_tab + a0 + a];
    }
    for (int i = tid; i < nzp * CA; i += blockDim.x) {
      const int row = i / CA, a = i - row * CA;
      sZ[row * CA + a] = gZ[(size_t)row * p.n_tab + a0 + a];
    }
    __syncthreads();
#pragma unroll 2
    for (int a = 0; a < CA; ++a) {
      const float2 ex = myX[a];
      const float4 lo = myLo[a], hi = myHi[a];
      float2 A[kTileY];
      A[0] = make_float2(ex.x * lo.x - ex.y * lo.y, ex.x * lo.y + ex.y * lo.x);
      A[1] = make_float2(ex.x * lo.z - ex.y * lo.w, ex.x * lo.w + ex.y * lo.z);
      A[2] = make_float2(ex.x * hi.x - ex.y * hi.y, ex.x * hi.y + ex.y * hi.x);
      A[3] = make_float2(ex.x * hi.z - ex.y * hi.w, ex.x * hi.w + ex.y * hi.z);
#pragma unroll
      for (int z = 0; z < kTileZ; ++z) {
        const float2 e = myZ[z * CA + a];
#pragma unroll
        for (int b = 0; b < kTileY; ++b) {
          acc[b][z].x = fmaf(A[b].x, e.x, fmaf(-A[b].y, e.y, acc[b][z].x));
          acc[b][z].y = fmaf(A[b].x, e.y, fmaf(A[b].y, e.x, acc[b][z].y));
        }
      }
    }
  }
  // the range's partial block, [nz][ny % 4][slot]
  float2* dst = p.part + (size_t)blockIdx.y * nzp * kTileY * p.stot + s;
#pragma unroll
  for (int z = 0; z < kTileZ; ++z)
#pragma unroll
    for (int b = 0; b < kTileY; ++b)
      dst[(size_t)((zg * kTileZ + z) * kTileY + b) * p.stot] = acc[b][z];
}

// S = the sum of the ranges' partial blocks in ascending range order, each
// element written to its place in the list (inv: -1 none, -2 the (0, 0, 0)
// element, which the pad modes k_real .. kp take).
__global__ void structure_reduce_kernel(const float2* part, const int* inv,
                                        int n_ranges, int dense, int k_real,
                                        int kp, float* s_re, float* s_im) {
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= dense) return;
  const int k = inv[d];
  if (k == -1) return;
  float re = 0.f, im = 0.f;
  for (int r = 0; r < n_ranges; ++r) {
    const float2 v = part[(size_t)r * dense + d];
    re += v.x;
    im += v.y;
  }
  if (k >= 0) {
    s_re[k] = re;
    s_im[k] = im;
  } else {
    for (int j = k_real; j < kp; ++j) {
      s_re[j] = re;
      s_im[j] = im;
    }
  }
}

// The k values of one axis, n = 0 .. km: (2 pi n) / L in the list's own
// rounding (ops/ewald_fused.py:_prep), written by the block's first threads.
__device__ __forceinline__ void stage_axis_k(float* s_k, int km, float L) {
  for (int n = threadIdx.x; n <= km; n += blockDim.x) s_k[n] = axis_k(n, L);
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

// B4: S_re, S_im (kp,) of pos (n_pad, 3), q (n_pad,) over the half-space
// list of kmax = (kmx, kmy, kmz) in box (3,), K = k_real modes padded to kp.
// The tiling (sb .. nxp) and inv come from ops/ewald_fused.py:
// structure_tiling and _dense_to_list_t; tab is n_tab * (2 nxp + 14 nzg +
// 8 nyg) floats of scratch (n_tab = n_pad rounded up to 32) and part (ranges,
// nzg * 7 * 4 * blocks_x * sb) float2 scratch.  Returns cudaGetLastError().
int ewald_structure_launch(const float* pos, const float* q, const float* box,
                           float* tab, float* part, const int* inv,
                           float* s_re, float* s_im, int kmx, int kmy,
                           int kmz, int n_pad, int kp, int k_real, int sb,
                           int nyg, int nzg, int blocks_x, int ranges,
                           int atoms_per, int nxr, int nxp, void* stream) {
  const int n_tab = (n_pad + kStageAtoms - 1) / kStageAtoms * kStageAtoms;
  if (n_pad <= 0 || kp <= 0 || kmx < 0 || kmy < 0 || kmz < 0 || sb < 32 ||
      sb % 32 != 0 || sb * nzg > kMaxTileThreads ||
      nyg * kTileY < 2 * kmy + 1 || nzg * kTileZ < kmz + 1 ||
      blocks_x * sb < (2 * kmx + 1) * nyg || ranges < 1 ||
      atoms_per % kStageAtoms != 0 || (long long)ranges * atoms_per < n_tab ||
      nxr < (sb - 1) / nyg + 2 || nxp < ((blocks_x - 1) * sb) / nyg + nxr ||
      k_real > kp)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)2 * nyg * (kStageAtoms + 1) * sizeof(float4) +
                      (size_t)nxr * (kStageAtoms + 2) * sizeof(float2) +
                      (size_t)nzg * kTileZ * kStageAtoms * sizeof(float2);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  static size_t raised = 48 * 1024;  // the most a block may ask so far
  if (smem > raised) {
    cudaError_t e = cudaFuncSetAttribute(
        structure_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    raised = smem;
  }
  TileParams p;
  p.pos = pos;
  p.q = q;
  p.box = box;
  p.tab = tab;
  p.part = reinterpret_cast<float2*>(part);
  p.kmx = kmx;
  p.kmy = kmy;
  p.kmz = kmz;
  p.n_pad = n_pad;
  p.n_tab = n_tab;
  p.sb = sb;
  p.nyg = nyg;
  p.nzg = nzg;
  p.stot = blocks_x * sb;
  p.atoms_per = atoms_per;
  p.nxr = nxr;
  p.nxp = nxp;
  cudaStream_t st = (cudaStream_t)stream;
  phase_table_kernel<<<dim3((n_tab + 255) / 256,
                            nxp + nzg * kTileZ + nyg * kTileY),
                       256, 0, st>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  structure_tile_kernel<<<dim3(blocks_x, ranges), sb * nzg, smem, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int dense = nzg * kTileZ * kTileY * p.stot;
  structure_reduce_kernel<<<(dense + 255) / 256, 256, 0, st>>>(
      p.part, inv, ranges, dense, k_real, kp, s_re, s_im);
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
