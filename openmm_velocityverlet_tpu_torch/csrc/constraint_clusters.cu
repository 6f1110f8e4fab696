// The constraint clusters: SHAKE and RATTLE of the bucketed cluster solver
// of ops/constraints.py, one thread a cluster, for Hopper.
//
// Replaces no TPU kernel.  The JAX package solves its constraint clusters in
// plain jnp (openmm_velocityverlet_tpu/ops/constraints.py), which XLA fuses
// into a few kernels.  Run eagerly in PyTorch, the same component-tensor
// code is one launch an elementwise operation: some 771 for one SHAKE call
// and 250 for one RATTLE call on a bucket of rigid triangles, each a few
// microseconds of device work behind several of the host's.  This kernel
// does one bucket's whole solve in one launch.
//
// A bucket holds the clusters of one topology pattern (ops/constraints.py:
// build_constraint_data): K <= 4 constraints over A <= 5 atom slots, the
// pattern's (first slot, second slot) of each constraint a kernel argument.
// The tables are (., ncl): gid (A, ncl) the global row of each slot, d2
// (K, ncl) the squared distances, w (K, K, ncl) the coupling weights,
// invm (A, ncl) the inverse masses; the box is read from the device.
//   * SHAKE: the plain version's newton_iters Newton iterations on
//     sigma_k = |x_a - x_b|^2 - d2_k with J_kl = 2 w_kl (delta_k . ref_l),
//     the same minimum image (rintf rounds half to even, as torch.round
//     does), Cramer's rule for K <= 3 and the unrolled elimination for
//     K = 4, and the same order of the updates to the atoms.
//   * RATTLE: its one linear solve, J_kl = w_kl (r_k . r_l), right-hand side
//     the relative velocities along the bonds, the atoms updated constraint
//     by constraint in key order.
// Both write the solved rows of their clusters into the output, a copy of
// the target the wrapper made; rows outside any cluster are not touched.
// Each atom lies in at most one cluster, so no two threads write a row.
// The kernels read gid unchecked: the wrapper raises unless the tables were
// built for the rows' atom count, which puts every gid in range.
//
// Agreement: float32 arithmetic throughout, as the plain version.  nvcc
// contracts multiply-adds into fma, so the kernel agrees with the plain
// version to float32 rounding, not bitwise.
//
// Bound: bytes.  A cluster reads its A rows of the reference and of the
// target and writes A rows (3 floats each), and reads A + K + K^2 + A table
// entries (RATTLE no d2): at 3,900 rigid triangles 0.70 MB for SHAKE and
// 0.66 MB for RATTLE, 0.00021 / 0.00020 ms at 3.35 TB/s.  The arithmetic,
// some 150 operations a cluster and Newton iteration, is smaller still.
// The launch itself dominates.
//
// Design.  Everything lives in registers: the slot of an atom in a
// constraint is known only at run time, so an atom's coordinate is picked
// from the per-slot registers by a chain of selects over the A slots (no
// indexing into a register array by a run-time value, which would put it
// in local memory).  The table reads coalesce by slot: neighbouring threads
// read neighbouring entries of each row of gid, d2, w and invm.  The row
// reads follow gid: the clusters of a molecule type lie in atom order, so
// neighbouring threads read neighbouring rows.  No shared memory, no
// synchronisation.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

struct Pattern {
  int a[4];  // the first atom slot of each constraint
  int b[4];  // the second atom slot
};

// v[s] for a slot s known only at run time, in registers.
template <int A>
__device__ __forceinline__ float pick(const float (&v)[A], int s) {
  float r = v[0];
#pragma unroll
  for (int a = 1; a < A; ++a) r = s == a ? v[a] : r;
  return r;
}

__device__ __forceinline__ float min_image(float d, float box) {
  return d - box * rintf(d / box);
}

// +1 where slot a is constraint k's first atom, -1 its second, else 0.
__device__ __forceinline__ float sign_of(const Pattern& p, int k, int a) {
  return p.a[k] == a ? 1.f : (p.b[k] == a ? -1.f : 0.f);
}

// The K x K solve of the plain version's _solve, formula for formula.
template <int K>
__device__ __forceinline__ void solve(float (&J)[K][K], const float (&b)[K],
                                      float (&x)[K]) {
  if constexpr (K == 1) {
    x[0] = b[0] / J[0][0];
  } else if constexpr (K == 2) {
    const float det = J[0][0] * J[1][1] - J[0][1] * J[1][0];
    const float inv = 1.f / det;
    x[0] = (J[1][1] * b[0] - J[0][1] * b[1]) * inv;
    x[1] = (J[0][0] * b[1] - J[1][0] * b[0]) * inv;
  } else if constexpr (K == 3) {
    const float c00 = J[1][1] * J[2][2] - J[1][2] * J[2][1];
    const float c01 = J[1][2] * J[2][0] - J[1][0] * J[2][2];
    const float c02 = J[1][0] * J[2][1] - J[1][1] * J[2][0];
    const float det = J[0][0] * c00 + J[0][1] * c01 + J[0][2] * c02;
    const float inv = 1.f / det;
    x[0] = (b[0] * c00 + J[0][1] * (J[1][2] * b[2] - J[2][2] * b[1])
            + J[0][2] * (J[2][1] * b[1] - J[1][1] * b[2])) * inv;
    x[1] = (J[0][0] * (J[2][2] * b[1] - J[1][2] * b[2]) + b[0] * c01
            + J[0][2] * (J[1][0] * b[2] - J[2][0] * b[1])) * inv;
    x[2] = (J[0][0] * (J[1][1] * b[2] - J[2][1] * b[1])
            + J[0][1] * (J[2][0] * b[1] - J[1][0] * b[2]) + b[0] * c02) * inv;
  } else {
    // unrolled Gaussian elimination (SPD Gram matrix, no pivoting)
    float r[K];
#pragma unroll
    for (int k = 0; k < K; ++k) r[k] = b[k];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float inv = 1.f / J[k][k];
#pragma unroll
      for (int l = k + 1; l < K; ++l) {
        const float f = J[l][k] * inv;
#pragma unroll
        for (int m = k; m < K; ++m) J[l][m] = J[l][m] - f * J[k][m];
        r[l] = r[l] - f * r[k];
      }
    }
#pragma unroll
    for (int k = K - 1; k >= 0; --k) {
      float acc = r[k];
#pragma unroll
      for (int l = k + 1; l < K; ++l) acc = acc - J[k][l] * x[l];
      x[k] = acc / J[k][k];
    }
  }
}

// Reads a cluster's slots: global rows, inverse masses and the rows of
// ``ref`` and ``tgt``.
template <int A>
__device__ __forceinline__ void load_cluster(
    int c, int ncl, const int* __restrict__ gid,
    const float* __restrict__ invm, const float* __restrict__ ref,
    const float* __restrict__ tgt, int (&g)[A], float (&im)[A],
    float (&r)[3][A], float (&x)[3][A]) {
#pragma unroll
  for (int a = 0; a < A; ++a) {
    g[a] = gid[a * ncl + c];
    im[a] = invm[a * ncl + c];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      r[d][a] = ref[3 * (size_t)g[a] + d];
      x[d][a] = tgt[3 * (size_t)g[a] + d];
    }
  }
}

// SHAKE: ref the constraint-satisfying positions, tgt the unconstrained.
template <int K, int A>
__global__ void __launch_bounds__(kThreads)
shake_kernel(Pattern p, int ncl, const float* __restrict__ ref,
             const float* __restrict__ tgt, float* __restrict__ out,
             const int* __restrict__ gid, const float* __restrict__ d2,
             const float* __restrict__ w, const float* __restrict__ invm,
             const float* __restrict__ box, int iters) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= ncl) return;
  const float L[3] = {box[0], box[1], box[2]};
  int g[A];
  float im[A], r[3][A], x[3][A];
  load_cluster<A>(c, ncl, gid, invm, ref, tgt, g, im, r, x);
  float e[3][K], dd[K], ww[K][K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    dd[k] = d2[k * ncl + c];
#pragma unroll
    for (int d = 0; d < 3; ++d)
      e[d][k] = min_image(pick<A>(r[d], p.a[k]) - pick<A>(r[d], p.b[k]),
                          L[d]);
#pragma unroll
    for (int l = 0; l < K; ++l) ww[k][l] = w[(k * K + l) * ncl + c];
  }
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    float dl[3][K], sg[K], J[K][K], gg[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int d = 0; d < 3; ++d)
        dl[d][k] = min_image(pick<A>(x[d], p.a[k]) - pick<A>(x[d], p.b[k]),
                             L[d]);
      sg[k] = dl[0][k] * dl[0][k] + dl[1][k] * dl[1][k] + dl[2][k] * dl[2][k]
              - dd[k];
    }
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int l = 0; l < K; ++l)
        J[k][l] = 2.f * ww[k][l] * (dl[0][k] * e[0][l] + dl[1][k] * e[1][l]
                                    + dl[2][k] * e[2][l]);
    solve<K>(J, sg, gg);
#pragma unroll
    for (int a = 0; a < A; ++a) {
      float acc[3] = {0.f, 0.f, 0.f};
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float s = sign_of(p, k, a);
        if (s != 0.f) {
#pragma unroll
          for (int d = 0; d < 3; ++d) acc[d] += s * gg[k] * e[d][k];
        }
      }
#pragma unroll
      for (int d = 0; d < 3; ++d) x[d][a] = x[d][a] - im[a] * acc[d];
    }
  }
#pragma unroll
  for (int a = 0; a < A; ++a)
#pragma unroll
    for (int d = 0; d < 3; ++d) out[3 * (size_t)g[a] + d] = x[d][a];
}

// RATTLE: pos the positions, tgt the velocities.
template <int K, int A>
__global__ void __launch_bounds__(kThreads)
rattle_kernel(Pattern p, int ncl, const float* __restrict__ pos,
              const float* __restrict__ tgt, float* __restrict__ out,
              const int* __restrict__ gid, const float* __restrict__ w,
              const float* __restrict__ invm, const float* __restrict__ box) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= ncl) return;
  const float L[3] = {box[0], box[1], box[2]};
  int g[A];
  float im[A], r[3][A], v[3][A];
  load_cluster<A>(c, ncl, gid, invm, pos, tgt, g, im, r, v);
  float e[3][K], rv[K], J[K][K], gg[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int d = 0; d < 3; ++d)
      e[d][k] = min_image(pick<A>(r[d], p.a[k]) - pick<A>(r[d], p.b[k]),
                          L[d]);
    rv[k] = (pick<A>(v[0], p.a[k]) - pick<A>(v[0], p.b[k])) * e[0][k]
            + (pick<A>(v[1], p.a[k]) - pick<A>(v[1], p.b[k])) * e[1][k]
            + (pick<A>(v[2], p.a[k]) - pick<A>(v[2], p.b[k])) * e[2][k];
  }
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int l = 0; l < K; ++l)
      J[k][l] = w[(k * K + l) * ncl + c]
                * (e[0][k] * e[0][l] + e[1][k] * e[1][l] + e[2][k] * e[2][l]);
  solve<K>(J, rv, gg);
#pragma unroll
  for (int a = 0; a < A; ++a)
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float s = sign_of(p, k, a);
      if (s != 0.f) {
#pragma unroll
        for (int d = 0; d < 3; ++d)
          v[d][a] = v[d][a] - im[a] * s * gg[k] * e[d][k];
      }
    }
#pragma unroll
  for (int a = 0; a < A; ++a)
#pragma unroll
    for (int d = 0; d < 3; ++d) out[3 * (size_t)g[a] + d] = v[d][a];
}

template <int K, int A>
cudaError_t launch(int rattle, const Pattern& p, int ncl,
                   const float* ref, const float* tgt, float* out,
                   const int* gid, const float* d2, const float* w,
                   const float* invm, const float* box, int iters,
                   cudaStream_t st) {
  const int blocks = (ncl + kThreads - 1) / kThreads;
  if (rattle)
    rattle_kernel<K, A><<<blocks, kThreads, 0, st>>>(
        p, ncl, ref, tgt, out, gid, w, invm, box);
  else
    shake_kernel<K, A><<<blocks, kThreads, 0, st>>>(
        p, ncl, ref, tgt, out, gid, d2, w, invm, box, iters);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One bucket: rattle 0 for SHAKE (ref the reference positions, tgt the
// unconstrained positions, d2 and iters read), 1 for RATTLE (ref the
// positions, tgt the velocities).  slots holds the pattern's 2 K host ints,
// the first slots of the K constraints, then their second slots.  out,
// shaped as tgt, receives the clusters' rows; every gid must index a row of
// ref, tgt and out, which the kernels do not check.  Returns
// cudaGetLastError() of the launch (0 on success), cudaErrorInvalidValue for
// a pattern no connected cluster of K <= 4 constraints has.
int constraint_clusters_launch(int rattle, int K, int A, const int* slots,
                               int ncl, const float* ref,
                               const float* tgt, float* out, const int* gid,
                               const float* d2, const float* w,
                               const float* invm, const float* box,
                               int iters, void* stream) {
  if (K < 1 || K > 4 || A < 2 || A > K + 1 || ncl < 0 || iters < 0
      || (!rattle && d2 == nullptr))
    return (int)cudaErrorInvalidValue;
  Pattern p = {};
  for (int k = 0; k < K; ++k) {
    p.a[k] = slots[k];
    p.b[k] = slots[K + k];
    if (p.a[k] < 0 || p.a[k] >= A || p.b[k] < 0 || p.b[k] >= A
        || p.a[k] == p.b[k])
      return (int)cudaErrorInvalidValue;
  }
  if (ncl == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
#define CC_CASE(KK, AA)                                                    \
  if (K == KK && A == AA) {                                                \
    err = launch<KK, AA>(rattle, p, ncl, ref, tgt, out, gid, d2, w, invm,  \
                         box, iters, st);                                  \
    return (int)err;                                                       \
  }
  CC_CASE(1, 2)
  CC_CASE(2, 3)
  CC_CASE(3, 3)
  CC_CASE(3, 4)
  CC_CASE(4, 4)
  CC_CASE(4, 5)
#undef CC_CASE
  return (int)cudaErrorInvalidValue;
}

const char* constraint_clusters_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
