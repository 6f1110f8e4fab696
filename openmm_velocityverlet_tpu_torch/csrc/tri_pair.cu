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
//   * mode 2 "bandall": j = (gi+o) mod n_tiles_g, o = 0..band_w, on the
//     z-sorted layout, exclusions tested on the carried original indices;
//     with full_sweep every unordered tile pair (band_w = n_tiles_g/2, and
//     for an even tile count the pair at offset n_tiles_g/2 only when
//     gi < j).  Row-sharded form: the call's rows are the n_row_tiles tiles
//     from row_off on, gi = i + row_off is the global row tile, n_tiles_g
//     the ring the column tile wraps on; the column side is full-length and
//     the rows output is local.
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
// Outputs keep the JAX layout: rows (n_row_tiles * ts, 8) = fx, fy, fz, e_lj,
// e_coul, e_corr, e14_coul, e14_lj and colacc (8, n_pad) with the reaction in
// rows 0..2.
//
// Bound: operations.  The function needs ~70 FP32 operations for each pair
// within the cutoff; the bytes (positions and per-atom columns once, the
// outputs) are small next to that.  What a kernel loses against the bound
// is (a) pairs it evaluates beyond the cutoff, because an enumeration names
// tile pairs and a tile is a slab of atoms, not a sphere, and (b)
// instructions a pair beside the arithmetic.  The TPU kernel evaluates every
// pair of every tile pair (60 for each pair within the cutoff at 19,500
// atoms); this one evaluates a pair only where a warp vote says its column
// may be in reach.
//
// Design (the machinery of kernel B1, csrc/plist_pair.cu, without a list).
//   * The unit of work is a "chunk" of 32 consecutive atoms: a warp holds
//     the 32 atoms of one row chunk in registers, one a lane, in the frame
//     of the chunk's first atom.  An item is (row chunk, entry, column
//     chunk): 32 x 32 pairs.  ts is any multiple of 32 up to 768.
//   * Two levels of skip.  chunk_box_kernel writes every chunk's bounding
//     box once a call.  A warp tests 32 items at a time, one a lane: the
//     periodic distance between the row chunk's box and the column chunk's
//     (both grown by 0.001 nm for float32 rounding) against the cutoff;
//     __ballot_sync gives the items to visit, and an item out of reach
//     costs no load and no write.  In a visited item each lane loads one
//     column atom, wraps it next to the row box's centre and tests its
//     distance to that box; the ballot gives the columns to visit, four a
//     round.  Both distances bound every pair's minimum-image distance from
//     below, so no pair inside the cutoff is dropped.  The skip is worth
//     what the layout makes of a chunk: ops/pair_tri.py orders the atoms of
//     a z-sorted tile in strips along x that run along y, so that a chunk is
//     a compact rectangle of the slab and not a sheet across the box.
//   * Excluded and folded 1-4 pairs count at any distance.  The host marks,
//     in a bitmap over (row chunk, column chunk), every chunk pair that
//     holds such a pair, and every chunk with itself (ops/pair_tri.py:
//     chunk_pair_map, rebuilt with the layout).  A marked item skips
//     nothing, tests the masks, and takes rows and columns as stored with
//     the minimum image per pair, so that coincident atoms (a Drude particle
//     on its core) keep dx = 0 exactly.  An unmarked item holds no excluded
//     pair and no atom with itself, and tests nothing but the cutoff.
//   * Minimum image once a column: the column sits within half a box of the
//     row box's centre; when the box's half extent is below L/2 - cutoff the
//     plain difference is the minimum image of every pair inside the cutoff,
//     and the per-pair rintf is left out.
//   * Four columns a round: four independent chains for the scheduler, and
//     one halving-exchange reduction of their reactions (1.5 shuffles a
//     component a column, fixed order).
//   * Blocks are eight independent warps.  A row chunk's items are cut into
//     `splits` contiguous ranges, one a warp, so that neither a wide band nor
//     the full sweep hangs on its longest row; chosen from the shapes alone.
//     The row chunk's LJ rows sit in the warp's shared memory with an odd
//     stride (one conflict-free read by the broadcast column type; pad
//     columns index a zero entry); when they do not fit, that call reads
//     them with __ldg.
//   * No float atomics.  Each warp writes one row partial, each visited item
//     its 3 x 32 column partial and a flag; tri_reduce_kernel adds, per tile,
//     the row partials in split order and the flagged column partials in
//     enumeration order (offset, then row chunk).  Bitwise equal from run to
//     run (checked by chip_smoke.py and tests/test_torch_kernels.py).
//   * Tensor cores have no part here, as in B1: the TPU kernel's only matrix
//     product was the one-hot LJ lookup, an index on this card.
//
// Rounding: as B1; a column pre-wrapped next to the row chunk differs in its
// last bit from a per-pair minimum image, so the kernel agrees with its plain
// torch version to float32 rounding, not bitwise.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxTs = 768;
constexpr int kNCoef = 11;
constexpr int kWarps = 8;             // warps a block
constexpr int kBatch = 4;             // columns a round of the pair loop
constexpr float kOne4PiEps0 = 138.935456f;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kBoxSlack = 1e-3f;    // nm added to a chunk box's half extent
constexpr int kMaxSmem = 100 * 1024;  // dynamic shared memory a block may ask
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
  const unsigned* cmap; // (n_chunks, n_words) marked chunk pairs, or null
  float4* cbox;         // (n_chunks, 2) chunk boxes: centre | half extent
  float* prow;          // (n_tasks, 8, 32) per-warp row partials
  float* pcol;          // (n_row_chunks * n_items, 3, 32) per-item partials
  unsigned char* iflag; // (n_row_chunks * n_items,) 1 where an item was run
  unsigned long long* evals;  // optional: pair evaluations made, else null
  int ab_w, t_dim, g_dim, ts, nrc, n_tiles, mode, band_w, full_sweep;
  int row_off, ntg, n_row_tiles;  // the row-sharded form (bandall)
  int n_ept;            // entries a row tile
  int n_items;          // items a row chunk: n_ept * nrc
  int splits, per;      // warps a row chunk, items a warp
  int n_tasks;          // n_row_tiles * nrc * splits
  int n_words;          // words of a cmap row
  int Kp, Gp;           // strides of the LJ rows in shared memory
  float beta, rc2, r_cutoff, r_switch, cap3, gauss_pref;
  float pc[kNCoef];
};

// Column tile of entry e of global row tile gi; false for an entry the
// enumeration skips.
__device__ __forceinline__ bool entry_tile(const Params& p, int gi, int e,
                                           int* tj) {
  if (p.mode == kBandAll) {
    const int j = (gi + e) % p.ntg;
    *tj = j;
    // offset ntg/2 enumerates each unordered pair twice: keep gi < j
    if (p.full_sweep && (p.ntg % 2 == 0) && 2 * e == p.ntg) return gi < j;
    return true;
  }
  if (p.mode == kBand) {
    *tj = gi + e;
    return gi + e < p.n_tiles;
  }
  *tj = e;
  return e >= gi + 2;
}

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

// The bounding box of a chunk over its real atoms (type >= 0), in the frame
// of the chunk's first real atom: each lane passes its atom and gets it back
// wrapped into that frame; m is the centre (m.w = 1 for a chunk with a real
// atom, else 0) and h the half extent grown by kBoxSlack.
__device__ __forceinline__ void chunk_box(float& x, float& y, float& z,
                                          bool real, const float* box,
                                          float4* m, float4* h) {
  const float bx = box[0], by = box[1], bz = box[2];
  const unsigned rm = __ballot_sync(kFull, real);
  const int first = rm != 0 ? __ffs(rm) - 1 : 0;
  x = wrap_frame(x, __shfl_sync(kFull, x, first), bx, 1.0f / bx);
  y = wrap_frame(y, __shfl_sync(kFull, y, first), by, 1.0f / by);
  z = wrap_frame(z, __shfl_sync(kFull, z, first), bz, 1.0f / bz);
  const float big = 3.0e38f;
  const float lox = warp_min(real ? x : big), hix = warp_max(real ? x : -big);
  const float loy = warp_min(real ? y : big), hiy = warp_max(real ? y : -big);
  const float loz = warp_min(real ? z : big), hiz = warp_max(real ? z : -big);
  const bool any = hix >= lox;
  *m = make_float4(any ? 0.5f * (lox + hix) : 0.f,
                   any ? 0.5f * (loy + hiy) : 0.f,
                   any ? 0.5f * (loz + hiz) : 0.f, any ? 1.f : 0.f);
  *h = make_float4(any ? 0.5f * (hix - lox) + kBoxSlack : 0.f,
                   any ? 0.5f * (hiy - loy) + kBoxSlack : 0.f,
                   any ? 0.5f * (hiz - loz) + kBoxSlack : 0.f, 0.f);
}

// One warp a chunk: cbox[2 c] = centre, cbox[2 c + 1] = half extent.
__global__ void chunk_box_kernel(Params p, int n_chunks) {
  const int c = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (c >= n_chunks) return;
  const int a = c * 32 + (threadIdx.x & 31);
  float x = p.pos[3 * a], y = p.pos[3 * a + 1], z = p.pos[3 * a + 2];
  float4 m, h;
  chunk_box(x, y, z, p.ctype[a] >= 0, p.box, &m, &h);
  if ((threadIdx.x & 31) == 0) {
    p.cbox[2 * c] = m;
    p.cbox[2 * c + 1] = h;
  }
}

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

// Bytes of one warp's shared memory: 32 column atoms as float4 (x, y, z, q),
// int2 (bits, id), int (type | group << 16) and int (1-4 bits), the item's
// 3 x 32 column sums; then the row chunk's LJ rows when they are staged.
__host__ __device__ inline int warp_smem_bytes(int Kp, int Gp, bool has14,
                                               bool lj_shared) {
  int n = 32 * (16 + 8 + 4 + 4) + 96 * 4;
  if (lj_shared) n += 32 * Kp * 8 * (has14 ? 2 : 1) + 32 * Gp * 4;
  return n;
}

template <bool WantEnergy, bool TestExcl, bool Has14, bool LjShared>
__global__ void __launch_bounds__(kWarps * 32, 2)
tri_pair_kernel(Params p) {
  extern __shared__ float4 smem4[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int task = blockIdx.x * kWarps + warp;
  if (task >= p.n_tasks) return;  // warps are independent: no block barrier
  const int wbytes = warp_smem_bytes(p.Kp, p.Gp, Has14, LjShared);
  char* base = reinterpret_cast<char*>(smem4) + (size_t)warp * wbytes;
  float4* s_c4 = reinterpret_cast<float4*>(base);
  int2* s_bo = reinterpret_cast<int2*>(s_c4 + 32);
  int* s_tg = reinterpret_cast<int*>(s_bo + 32);
  int* s_b14 = s_tg + 32;
  float* gcol = reinterpret_cast<float*>(s_b14 + 32);
  float2* s_ab = reinterpret_cast<float2*>(gcol + 96);
  float2* s_ab14 = s_ab + (LjShared ? 32 * p.Kp : 0);
  float* s_g = reinterpret_cast<float*>(
      s_ab14 + (LjShared && Has14 ? 32 * p.Kp : 0));

  const int nrc = p.nrc, ts = p.ts, T = p.t_dim;
  const bool groups = p.grows != nullptr;
  const bool by_position = p.mode == kBand;
  const int rl = task / p.splits;         // local row chunk
  const int sp = task - rl * p.splits;    // its split
  const int il = rl / nrc;
  const int gi = il + p.row_off;          // global row tile
  const int rg = gi * nrc + (rl - il * nrc);  // global row chunk
  const int row = rg * 32 + lane;

  const float bx = p.box[0], by = p.box[1], bz = p.box[2];
  const float ibx = 1.0f / bx, iby = 1.0f / by, ibz = 1.0f / bz;
  // the row as stored, for marked items: a pair of coincident atoms must
  // keep dx = 0 exactly, as the energy form's excluded-pair force divides
  // by r^2
  const float pxr = p.pos[3 * row], pyr = p.pos[3 * row + 1],
              pzr = p.pos[3 * row + 2];
  float px = pxr, py = pyr, pz = pzr;
  float4 m, h;
  chunk_box(px, py, pz, p.ctype[row] >= 0, p.box, &m, &h);
  const bool widex = !(h.x < 0.5f * bx - p.r_cutoff);
  const bool widey = !(h.y < 0.5f * by - p.r_cutoff);
  const bool widez = !(h.z < 0.5f * bz - p.r_cutoff);
  const float rc2_skip = p.rc2 * 1.0001f;

  const float qrow = kOne4PiEps0 * p.q[row];
  int bits_r = 0, bits14_r = 0, oid_r = 0;
  if (TestExcl) {
    bits_r = p.bits[row];
    oid_r = by_position ? row : p.oid[row];
    if (Has14) bits14_r = p.bits14[row];
  }
  const float* arow = p.ab + (size_t)row * p.ab_w;
  const float* grow = groups ? p.grows + (size_t)row * p.g_dim : nullptr;
  if (LjShared) {
    // each lane stages its own row; entry T is the pad columns' zero
    for (int c = 0; c < p.Kp; ++c) {
      const bool in = c < T;
      s_ab[lane * p.Kp + c] =
          in ? make_float2(arow[c], arow[T + c]) : make_float2(0.f, 0.f);
      if (Has14)
        s_ab14[lane * p.Kp + c] = in ? make_float2(arow[2 * T + c],
                                                   arow[3 * T + c])
                                     : make_float2(0.f, 0.f);
    }
    if (groups)
      for (int c = 0; c < p.Gp; ++c)
        s_g[lane * p.Gp + c] = c < p.g_dim ? grow[c] : 0.f;
  }
  const float2* s_abrow = s_ab + lane * p.Kp;
  const float2* s_ab14row = s_ab14 + lane * p.Kp;
  const float* s_grow = s_g + lane * p.Gp;
  __syncwarp();

  float fx = 0.f, fy = 0.f, fz = 0.f;
  float elj = 0.f, ecoul = 0.f, ecorr = 0.f, e14c = 0.f, e14l = 0.f;
  unsigned long long n_eval = 0;
  const int it_end = min((sp + 1) * p.per, p.n_items);
  const size_t item0 = (size_t)rl * p.n_items;
  for (int it_base = sp * p.per; it_base < it_end; it_base += 32) {
    // 32 items a round, one a lane: which are in reach of the row chunk
    unsigned todo, marked;
    {
      const int it = it_base + lane;
      const int e = it / nrc, cc = it - e * nrc;
      int tj = 0;
      const bool valid = it < it_end && entry_tile(p, gi, e, &tj);
      bool mark = false, reach = false;
      if (valid) {
        const int cg = tj * nrc + cc;
        if (TestExcl)
          mark = (p.cmap[(size_t)rg * p.n_words + (cg >> 5)] >> (cg & 31)) & 1u;
        const float4 cm = p.cbox[2 * cg], ch = p.cbox[2 * cg + 1];
        float ux = cm.x - m.x, uy = cm.y - m.y, uz = cm.z - m.z;
        ux -= bx * rintf(ux * ibx);
        uy -= by * rintf(uy * iby);
        uz -= bz * rintf(uz * ibz);
        const float gx = fmaxf(fabsf(ux) - h.x - ch.x, 0.f);
        const float gy = fmaxf(fabsf(uy) - h.y - ch.y, 0.f);
        const float gz = fmaxf(fabsf(uz) - h.z - ch.z, 0.f);
        reach = cm.w > 0.f && m.w > 0.f &&
                gx * gx + gy * gy + gz * gz <= rc2_skip;
      }
      const bool run = valid && (mark || reach);
      if (it < it_end) p.iflag[item0 + it] = run ? 1 : 0;
      todo = __ballot_sync(kFull, run);
      marked = __ballot_sync(kFull, mark);
    }
    while (todo != 0) {
      const int bsel = __ffs(todo) - 1;
      todo &= todo - 1;
      const bool flagged = (marked >> bsel) & 1u;
      const int it = it_base + bsel;
      const int e = it / nrc, cc = it - e * nrc;
      int tj = 0;
      entry_tile(p, gi, e, &tj);
      const bool diag = tj == gi;
      const int cj = (tj * nrc + cc) * 32 + lane;
      float cx = p.pos[3 * cj], cy = p.pos[3 * cj + 1], cz = p.pos[3 * cj + 2];
      const float cq = p.q[cj];
      const int ct = p.ctype[cj];
      // a marked item: rows and columns as stored, the minimum image per
      // pair, every real column visited
      const bool ppx = widex || flagged, ppy = widey || flagged,
                 ppz = widez || flagged;
      const float rx = flagged ? pxr : px, ry = flagged ? pyr : py,
                  rz = flagged ? pzr : pz;
      float ux = cx - m.x, uy = cy - m.y, uz = cz - m.z;
      ux -= bx * rintf(ux * ibx);
      uy -= by * rintf(uy * iby);
      uz -= bz * rintf(uz * ibz);
      if (!flagged) {
        cx = m.x + ux;
        cy = m.y + uy;
        cz = m.z + uz;
      }
      const float gpx = fmaxf(fabsf(ux) - h.x, 0.f);
      const float gpy = fmaxf(fabsf(uy) - h.y, 0.f);
      const float gpz = fmaxf(fabsf(uz) - h.z, 0.f);
      const bool keep =
          (flagged || gpx * gpx + gpy * gpy + gpz * gpz <= rc2_skip) &&
          ct >= 0;
      unsigned mask = __ballot_sync(kFull, keep);
      float* dst = p.pcol + (item0 + it) * 96 + lane;
      __syncwarp();
      s_c4[lane] = make_float4(cx, cy, cz, cq);
      s_tg[lane] = (ct < 0 ? T : ct) | (p.cgroup[cj] << 16);
      if (TestExcl && flagged) {
        s_bo[lane] = make_int2(p.bits[cj], by_position ? cj : p.oid[cj]);
        if (Has14) s_b14[lane] = p.bits14[cj];
      }
      gcol[lane] = 0.f;
      gcol[32 + lane] = 0.f;
      gcol[64 + lane] = 0.f;
      __syncwarp();
      float eelj = 0.f, eecoul = 0.f, eecorr = 0.f, ee14c = 0.f, ee14l = 0.f;
      while (mask != 0) {
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
          const bool live = jb[u] >= 0;  // an empty slot computes column 0
          const int j = live ? jb[u] : 0;  // for nothing
          const float4 c = s_c4[j];
          float dx = rx - c.x;
          float dy = ry - c.y;
          float dz = rz - c.z;
          if (ppx) dx = dx - bx * rintf(dx * ibx);
          if (ppy) dy = dy - by * rintf(dy * iby);
          if (ppz) dz = dz - bz * rintf(dz * ibz);
          const float r2 = dx * dx + dy * dy + dz * dz;

          bool excl = false, alive = live, is14 = false;
          if (TestExcl && flagged) {
            const int2 bo = s_bo[j];
            const int delta = bo.y - oid_r;
            const bool side = delta >= 0;
            const int dabs = side ? delta : -delta;
            const int dsh = dabs < 31 ? dabs : 31;  // a shift >= 32 is undefined
            const bool window = dabs <= 31;
            alive = live && delta != 0;
            const int bits_lo = side ? bits_r : bo.x;
            excl = ((((unsigned)bits_lo) >> dsh) & 1u) && window && alive;
            if (Has14) {
              const int b14_lo = side ? bits14_r : s_b14[j];
              is14 = ((((unsigned)b14_lo) >> dsh) & 1u) && window && alive;
            }
          }
          const int tg = s_tg[j];
          const int ctj = tg & 0xffff;
          float a, b, a14 = 0.f, b14 = 0.f;
          if (LjShared) {
            const float2 ab = s_abrow[ctj];
            a = ab.x;
            b = ab.y;
            if (groups) {
              const float allowed = s_grow[tg >> 16];
              a = a * allowed;
              b = b * allowed;
            }
            if (Has14 && is14) {
              const float2 ab14 = s_ab14row[ctj];
              a14 = ab14.x;
              b14 = ab14.y;
            }
          } else {
            a = 0.f;
            b = 0.f;
            if (ctj < T) {
              a = __ldg(arow + ctj);
              b = __ldg(arow + T + ctj);
              if (groups) {
                const float allowed = __ldg(grow + (tg >> 16));
                a = a * allowed;
                b = b * allowed;
              }
              if (Has14 && is14) {
                a14 = __ldg(arow + 2 * T + ctj);
                b14 = __ldg(arow + 3 * T + ctj);
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
          float f_s = (in_range ? f_lj + f_c : 0.f) + (corr ? f_x : 0.f);
          if (Has14 && is14) {
            const float e14_c = 0.5f * qq * inv_r;
            const float a14lj = a14 * inv_r6;
            const float e14_12 = a14lj * a14lj;
            const float e14_6 = b14 * inv_r6;
            f_s += (e14_c + 12.0f * e14_12 - 6.0f * e14_6) * inv_r2;
            if (WantEnergy) {
              ee14c += e14_c;
              ee14l += e14_12 - e14_6;
            }
          }
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
          // the columns' reactions: lane l ends with the sum over the 32
          // rows of slot l % kBatch; the first kBatch lanes store them
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
        dst[32] = gcol[32 + lane];
        dst[64] = gcol[64 + lane];
      }
      if (WantEnergy) {
        const float half = diag ? 0.5f : 1.0f;
        elj += half * eelj;
        ecoul += half * eecoul;
        ecorr += half * eecorr;
        e14c += half * ee14c;
        e14l += half * ee14l;
      }
    }
  }
  float* prow = p.prow + (size_t)task * 8 * 32 + lane;
  prow[0] = fx;
  prow[32] = fy;
  prow[64] = fz;
  if (WantEnergy) {
    prow[96] = elj;
    prow[128] = ecoul;
    prow[160] = ecorr;
    prow[192] = e14c;
    prow[224] = e14l;
  }
  if (p.evals != nullptr && lane == 0 && n_eval != 0)
    atomicAdd(p.evals, n_eval);  // an integer count: order does not matter
}

// One block a tile t, one thread an atom.  Rows (t a local row tile): the
// row partials of the atom's chunk, in split order.  Columns (t a tile of
// the whole layout): the partials of every item that was run with column
// tile t, off the diagonal, by ascending offset (bandall; far: by ascending
// row tile), then row tile image, then row chunk.
__global__ void __launch_bounds__(kMaxTs)
tri_reduce_kernel(Params p, int n_row_vals, float* rows, float* colacc) {
  const int t = blockIdx.x;
  const int r = threadIdx.x;
  const int cc = r >> 5, lane = r & 31;
  const int nrc = p.nrc;
  if (t < p.n_row_tiles) {
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    const float* src =
        p.prow + (size_t)(t * nrc + cc) * p.splits * 8 * 32 + lane;
    for (int s = 0; s < p.splits; ++s, src += 8 * 32)
      for (int c = 0; c < n_row_vals; ++c) acc[c] += src[c * 32];
    float4* dst = reinterpret_cast<float4*>(rows + ((size_t)t * p.ts + r) * 8);
    dst[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
    dst[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
  }
  if (t >= p.n_tiles) return;
  float g[3] = {0.f, 0.f, 0.f};
  // the entries (gi, e) whose column tile is t
  const int n_src = p.mode == kBandAll ? (t < p.ntg ? p.band_w + 1 : 0)
                    : p.mode == kBand  ? (t >= 1 ? 1 : 0)
                                       : (t >= 2 ? t - 1 : 0);
  for (int k = 0; k < n_src; ++k) {
    int gi0, e, step;
    if (p.mode == kBandAll) {
      gi0 = ((t - k) % p.ntg + p.ntg) % p.ntg;
      e = k;
      step = p.ntg;  // row tiles beyond the ring wrap onto the same column
    } else if (p.mode == kBand) {
      gi0 = t - 1;
      e = 1;
      step = p.n_tiles;
    } else {
      gi0 = k;
      e = t;
      step = p.n_tiles;
    }
    for (int gi = gi0; gi < p.n_tiles; gi += step) {
      const int il = gi - p.row_off;
      int tj;
      if (il < 0 || il >= p.n_row_tiles || gi == t ||
          !entry_tile(p, gi, e, &tj) || tj != t)
        continue;
      for (int rc = 0; rc < nrc; ++rc) {
        const size_t item =
            (size_t)(il * nrc + rc) * p.n_items + e * nrc + cc;
        if (!p.iflag[item]) continue;
        const float* src = p.pcol + item * 96 + lane;
        g[0] += src[0];
        g[1] += src[32];
        g[2] += src[64];
      }
    }
  }
  const size_t col = (size_t)t * p.ts + r;
  const size_t n_pad = (size_t)p.n_tiles * p.ts;
  for (int c = 0; c < 8; ++c) colacc[c * n_pad + col] = c < 3 ? g[c] : 0.f;
}

template <bool WantEnergy, bool TestExcl, bool Has14, bool LjShared>
cudaError_t launch_one(const Params& p, int n_blocks, int smem,
                       cudaStream_t st) {
  static bool raised = false;  // once a process: allow more than 48 KB
  if (!raised) {
    cudaError_t err = cudaFuncSetAttribute(
        tri_pair_kernel<WantEnergy, TestExcl, Has14, LjShared>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return err;
    raised = true;
  }
  tri_pair_kernel<WantEnergy, TestExcl, Has14, LjShared>
      <<<n_blocks, kWarps * 32, smem, st>>>(p);
  return cudaGetLastError();
}

template <bool WantEnergy, bool LjShared>
cudaError_t launch_pairs(const Params& p, bool has14, int n_blocks, int smem,
                         cudaStream_t st) {
  if (p.mode == kFar)
    return launch_one<WantEnergy, false, false, LjShared>(p, n_blocks, smem,
                                                          st);
  if (has14)
    return launch_one<WantEnergy, true, true, LjShared>(p, n_blocks, smem, st);
  return launch_one<WantEnergy, true, false, LjShared>(p, n_blocks, smem, st);
}

}  // namespace

extern "C" {

// Launches the chunk boxes, the pair kernel of one enumeration and the
// reduction on `stream`; returns cudaGetLastError() of the launches (0 on
// success).  cmap (n_pad / 32, n_words) marks the chunk pairs that hold an
// excluded or 1-4 pair (null in the far mode); splits and per cut a row
// chunk's items (ops/pair_tri.py:tri_tiling); cbox, prow, pcol and iflag are
// scratch; `evals`, when not null, is a device counter the kernel adds its
// pair evaluations to.
int tri_pair_launch(const float* pos, const float* q, const float* ab,
                    int ab_w, int t_dim, const int* ctype, const int* cgroup,
                    const float* grows, int g_dim, const int* bits,
                    const int* bits14, const int* oid, const float* box,
                    const unsigned* cmap, int n_words, int n_pad, int ts,
                    int mode, int band_w, int full_sweep, int want_energy,
                    int has14, int row_off, int n_tiles_g, int n_row_tiles,
                    int splits, int per, float beta, float rc2,
                    float r_cutoff, float r_switch, float cap3,
                    float gauss_pref, const float* pcoef, float* cbox,
                    float* prow, float* pcol, unsigned char* iflag,
                    float* rows, float* colacc, unsigned long long* evals,
                    void* stream) {
  if (ts < 32 || ts > kMaxTs || ts % 32 != 0 || n_pad % ts != 0 ||
      mode < kBand || mode > kBandAll || band_w < 0 || t_dim <= 0 ||
      t_dim >= 0xffff || splits < 1 || per < 1)
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
  p.cmap = cmap;
  p.cbox = reinterpret_cast<float4*>(cbox);
  p.prow = prow;
  p.pcol = pcol;
  p.iflag = iflag;
  p.evals = evals;
  p.ab_w = ab_w;
  p.t_dim = t_dim;
  p.g_dim = g_dim;
  p.ts = ts;
  p.nrc = ts / 32;
  p.n_tiles = n_pad / ts;
  p.mode = mode;
  p.band_w = mode == kBandAll ? band_w : 0;
  p.full_sweep = full_sweep;
  const int nt = p.n_tiles;
  if (nt == 0) return 0;
  p.row_off = mode == kBandAll ? row_off : 0;
  p.ntg = mode == kBandAll && n_tiles_g > 0 ? n_tiles_g : nt;
  p.n_row_tiles = mode == kBandAll && n_row_tiles > 0 ? n_row_tiles
                                                      : nt - p.row_off;
  if (p.row_off < 0 || p.n_row_tiles < 1 ||
      p.row_off + p.n_row_tiles > nt || p.ntg > nt ||
      (mode != kFar && cmap == nullptr))
    return (int)cudaErrorInvalidValue;
  p.n_ept = mode == kBandAll ? p.band_w + 1 : mode == kBand ? 2 : nt;
  p.n_items = p.n_ept * p.nrc;
  p.splits = splits;
  p.per = per;
  if ((long long)splits * per < p.n_items) return (int)cudaErrorInvalidValue;
  p.n_tasks = p.n_row_tiles * p.nrc * splits;
  p.n_words = n_words;
  p.Kp = (t_dim + 1) | 1;  // odd, and one zero entry for pad columns
  p.Gp = g_dim | 1;
  p.beta = beta;
  p.rc2 = rc2;
  p.r_cutoff = r_cutoff;
  p.r_switch = r_switch;
  p.cap3 = cap3;
  p.gauss_pref = gauss_pref;
  for (int c = 0; c < kNCoef; ++c) p.pc[c] = pcoef[c];
  cudaStream_t st = (cudaStream_t)stream;
  const int n_chunks = n_pad / 32;
  chunk_box_kernel<<<(n_chunks + kWarps - 1) / kWarps, kWarps * 32, 0, st>>>(
      p, n_chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const bool h14 = has14 != 0 && mode != kFar;
  const bool lj_shared =
      kWarps * warp_smem_bytes(p.Kp, p.Gp, h14, true) <= kMaxSmem;
  const int smem = kWarps * warp_smem_bytes(p.Kp, p.Gp, h14, lj_shared);
  const int n_blocks = (p.n_tasks + kWarps - 1) / kWarps;
  if (want_energy)
    err = lj_shared ? launch_pairs<true, true>(p, h14, n_blocks, smem, st)
                    : launch_pairs<true, false>(p, h14, n_blocks, smem, st);
  else
    err = lj_shared ? launch_pairs<false, true>(p, h14, n_blocks, smem, st)
                    : launch_pairs<false, false>(p, h14, n_blocks, smem, st);
  if (err != cudaSuccess) return (int)err;
  tri_reduce_kernel<<<nt, ts, 0, st>>>(p, want_energy ? 8 : 3, rows, colacc);
  return (int)cudaGetLastError();
}

const char* tri_pair_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
