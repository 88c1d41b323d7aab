// NDiv hinge loss kernels for Hopper (sm_90a), bound to Python via ctypes.
//
// Replaces the Pallas TPU kernels of ndivplanning_tpu/ops/ndiv_pallas.py:
//   ndiv_joint -> _joint_kernel_block (:266, pallas_call :505; hinge sum +
//                 unit-cotangent grads, one pass)
//   ndiv_fwd   -> _fwd_kernel_block and the packed _fwd_kernel (hinge sum only)
//   ndiv_bwd   -> _bwd_kernel_block and the packed _bwd_kernel (grads at an
//                 upstream cotangent g, recomputing the forward)
// in each of the TPU's three layouts "block", "group" and "packed" (below).
//
// Two kernels, chosen by shape alone, whatever the layout: every call with
// 2 <= k <= 32 (joint) or 2 <= k <= 64 (fwd and bwd) whose rows fit in
// shared memory runs ndiv_warp_kernel<mode, kp>; every other call (the
// joint past k = 32, anything past k = 64, rows past shared memory) runs
// ndiv_tile_kernel.  Both compute every
// per-condition value with the same helpers in the same order, so their
// grads are bitwise equal; a launch that fails raises in the wrapper.  The
// tile kernel can also be asked for at any shape (impl = kTile), as the
// reference the tests hold the warp kernel against; the dispatch never
// takes it in the warp kernel's place.

// Per condition b (k samples, latents z [k, dz], outputs x [k, dx]):
//   D_ij  = sqrt(max(sq_i + sq_j - 2 <a_i, a_j>, 0)), 0 on the diagonal
//   n_ij  = D_ij / r_i with r_i = sum_j D_ij (0 where r_i == 0)
//   hinge = sum_{i != j} max(alpha nz_ij - nx_ij, 0)
// Gradient at cotangent g (quotient rule through the row sums), M = B k (k-1):
//   s_ij  = [hinge_ij > 0, i != j] g / M,  g_n = alpha s (for z), -s (for x)
//   c_i   = sum_j g_n_ij n_ij,  gD_ij = (g_n_ij - c_i) / r_i  (0 if r_i == 0)
//   W_ij  = (gD_ij + gD_ji) / D_ij  (0 where D_ij == 0)
//   grad_i = sum_j W_ij (a_i - a_j)   (= rowsum(W)_i a_i - (W a)_i)
// ndiv_joint takes g = 1 (the autograd backward then scales by g);
// ndiv_bwd reads g from device memory, so a backward never synchronises.
// Subgradients: d sqrt = 0 at 0, relu' = 0 at exactly 0, 0/0 rows -> 0.
//
// Bound on an H100 SXM at its 700 W power limit (NVIDIA's data sheet:
// 3.35 TB/s; 67 TFLOP/s f32 and 34 TFLOP/s f64 outside the tensor cores):
// a grad kernel reads z and x once and writes grads as large, 8 B k (dz + dx)
// per call: at the imagecond shape (B=512, k=8, dz=2, dx=64) 2.2 MB,
// 0.65 us, below the few microseconds a launch costs; at pod_dp's per-rank
// shape (B=8192, k=32) 138 MB, 41 us: the bound is bytes at every shape
// the main paths run.  The work as done below, in f64 on the CUDA cores
// (each condition's Gram matrix, k^2 d fmas, and the grad sum, k^2 d
// subtractions and fmas), is ~2.8 GFLOP at pod_dp's shape, ~80 us at
// 34 TFLOP/s: twice the bytes bound, and the warp kernel's own floor.
//
// Precision.  f32 arithmetic, no tensor cores, except in two places that
// would cancel: the generator's samples of one condition can sit ~1e-3
// apart at |x|^2 ~ 16, where the Gram form in f32 keeps almost no digit of
// D (and rowsum(W) a_i - (W a)_i none of the grad).  So the norms and dot
// products accumulate in f64 and D is rounded to f32 only at the end, and
// the grad sums W_ij (a_i - a_j) in f64.  f64 mma (DMMA) would sum d in
// hardware-ordered chunks and break the bitwise equality of the two kernels.
//
// ndiv_warp_kernel: a team of warps per condition (two at k <= 16,
// four at 16 < k <= 32 with grads, where a single warp waits on its own
// latencies; two for fwd; eight at 32 < k <= 64), two teams or one per
// block of 128 threads (256 at kp = 64), persistent blocks walking over
// the conditions.  The
// team copies its condition's rows into shared memory once, coalesced and
// in one batch of loads, in f64 and transposed ([d][kp + 1], k padded to
// kp = 8, 16, 32 or 64 with zero rows), so nothing is converted or re-read
// from device memory in the f64 loops.  Its threads form a (kT / 8) x 8
// grid: thread (p, q) owns the entries (p + (kT / 8) u, q + 8 v) of every
// kp x kp matrix, a register tile of the Gram matrix whose step over t
// reads 4 and 8 neighbouring doubles a warp.  The k x k matrices have a
// row stride of kp + 1 floats, so row reads and the transposed read of W
// are free of bank conflicts.  The hinge phase stores each entry's c_i
// term (z's over the slack's matrix) and the slack as one bit an entry
// (a warp ballot, kp^2 / 8 bytes), so r_i and c_i are sequential sums of
// stored values, one thread a row, and two bwd conditions fit on an SM at
// kp = 64; as the slack is 0 or 1/M, a row's dL/dD takes two values, each
// computed once by that thread.  W is stored in f64
// over the dead D and dL/dD of its matrix, and the grad sum runs on the
// team's grid (x's wide rows) or one output a thread (z's narrow ones).
// The forward mode stops after the hinge and keeps only the rows and the
// two distance matrices in shared memory (~26 KB a condition at pod_dp's
// widths against the grad modes' ~35 KB), so 8 conditions reside on an SM
// instead of 5, on teams of two warps.  The backward mode is the joint
// one with the slack g / M on an active pair, rounded as the tile kernel
// rounds it, and no loss.
// One launch: each condition gets one loss partial, summed by the team
// that takes it in a fixed order, and the last block to take an
// integer ticket sums all partials in an order set by their count and
// resets the ticket: the total's bits depend on the shape alone, not on
// the grid (hence not on the card's SM count).  Joint at pod_dp's shape
// took ~0.34 ms, ~8x its bound (chip_smoke.py's kernels line, NVIDIA H100
// 80GB HBM3, 700 W), with 5 teams an SM (shared memory and registers both
// allow 5): x's Gram matrix and grad sum take most of it, with their f64
// fmas at their least count but the f64 pipes well short of full; the
// rest is f64 square roots, exact f32 divisions and index arithmetic.  Not
// used: f64 mma (it breaks the bitwise equality), cp.async double
// buffering.  At kp = 64 (8192 conditions at imagecond's widths) fwd took
// ~0.54 ms and bwd ~1.26 ms against bounds of 0.041 and 0.114 ms
// (ndiv_kernel_ab.py, same card): bwd ran 1.79 ms at one condition an SM
// until the slack's bits replaced a k x k matrix and two fit; recomputing
// z's c_i terms in the row phase instead cost 22% at kp <= 32.

// ndiv_tile_kernel.  On the TPU "block" gives each condition its own
// [kp, kp] Gram (kp = k rounded up to 8), "group" packs 128 // kp
// conditions into one [128, 128] Gram and "packed" 256 // kp into one
// [256, 256] Gram, under a block-diagonal mask: the same function on other
// lane layouts, packed to fill the MXU's lanes.  That reason does not
// exist on this card, so both kernels serve all three alike.  The tile
// kernel gives each condition a block of 256 threads and its k x k
// matrices shared memory (or global scratch, where they pass 48 KB).  Until
// the warp kernel took k <= 64 it also packed 128 // kp or 256 // kp
// conditions on one block for the group and packed layouts; at k = 64
// every such tiling was slower than one condition a block
// (ndiv_kernel_ab.py, NVIDIA H100 80GB HBM3, 700 W, at 8192 conditions:
// fwd 9.24 and 9.26 ms against 8.96, bwd 10.94 and 11.25 against 10.80,
// the joint 10.95 against 10.80), so they went.

// Determinism: no float atomics in either kernel.  The tile kernel's blocks
// each write one partial and a second one-block kernel sums the partials
// in a fixed order; the warp kernel sums its per-condition partials in
// its last block.  Repeated launches are bitwise equal.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr size_t kSmemLimit = 48 * 1024;
constexpr size_t kSmemOptin = 232448;  // a block's most, opted in (H100)

enum Mode : int { kFwd = 0, kJoint = 1, kBwd = 2 };

__host__ __device__ constexpr int mats_per_cond(int mode) {
  return mode == kFwd ? 2 : 4;
}

__device__ __forceinline__ double dot_rows(const float* __restrict__ a,
                                           const float* __restrict__ b, int d) {
  // fma(a, b, acc) == fma(b, a, acc), so dot_rows(a_i, a_j) and
  // dot_rows(a_j, a_i) agree bitwise and D comes out exactly symmetric;
  // dot_rows(a_i, a_i) is sq_i bitwise, so identical samples give D = 0.
  double acc = 0.0;
  for (int t = 0; t < d; ++t) acc = fma((double)a[t], (double)b[t], acc);
  return acc;
}

// The per-element formulas, one helper each, shared by both kernels: nvcc
// contracts a * b + c into an fma by the expression's shape, so each value
// is written once and rounds the same way in either kernel.

// D_ij from the f64 norms and dot product, rounded to f32 at the end.
__device__ __forceinline__ float pair_distance(double sq_i, double sq_j,
                                               double g) {
  return (float)sqrt(fmax((sq_i + sq_j) - 2.0 * g, 0.0));
}

// n_ij = D_ij / r_i, 0 where the row sums to 0.
__device__ __forceinline__ float row_normalized(float d, float r) {
  return r > 0.f ? d / r : 0.f;
}

// max(alpha nz - nx, 0); __fmul_rn keeps the product rounded on its own
// (no fma contraction), as the plain version computes it.
__device__ __forceinline__ float hinge_term(float alpha, float nz, float nx) {
  return fmaxf(__fmul_rn(alpha, nz) - nx, 0.f);
}

// One term g_n n of c_i = sum_j g_n_ij n_ij.
__device__ __forceinline__ float c_term(float g_n, float n) {
  return __fmul_rn(g_n, n);
}

// dL/dD_ij = (g_n - c_i) / r_i off the diagonal, 0 where r_i == 0.
__device__ __forceinline__ float dist_grad(bool valid, float g_n, float c,
                                           float r) {
  return (valid && r > 0.f) ? (g_n - c) / r : 0.f;
}

// W_ij = (dL/dD_ij + dL/dD_ji) / D_ij, 0 where D_ij == 0.
__device__ __forceinline__ float pair_weight(float g_ij, float g_ji, float d) {
  return d > 0.f ? (g_ij + g_ji) / d : 0.f;
}

// One step of the f64 chain sum_j W_ij (a_i - a_j).
__device__ __forceinline__ double grad_step(double w, double a_i, double a_j,
                                            double acc) {
  return fma(w, a_i - a_j, acc);
}

// sum_j W_ij (a_i - a_j)[c] in f64, for row i of W and column c of a [k, d].
__device__ __forceinline__ float weighted_diff(const float* __restrict__ w,
                                               const float* __restrict__ a,
                                               int k, int d, int i, int c) {
  const double ai = a[(size_t)i * d + c];
  double acc = 0.0;
  for (int j = 0; j < k; ++j)
    acc = grad_step((double)w[j], ai, (double)a[(size_t)j * d + c], acc);
  return (float)acc;
}

__device__ __forceinline__ float block_sum(float v, float* red) {
  const int tid = threadIdx.x;
  red[tid] = v;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] += red[tid + s];
    __syncthreads();
  }
  return red[0];
}

// One thread block per condition.  Each phase is a loop over the
// condition's elements on the block's threads, with a barrier between
// phases; every per-condition value is computed by one thread in a fixed
// sequential order.
template <int kMode>
__global__ void __launch_bounds__(kThreads)
ndiv_tile_kernel(const float* __restrict__ z, const float* __restrict__ x,
                 const float* __restrict__ g, int k, int dz, int dx,
                 float alpha, float inv_m, float* __restrict__ partial,
                 float* __restrict__ gz, float* __restrict__ gx,
                 float* __restrict__ scratch) {
  extern __shared__ float smem[];
  constexpr bool kGrads = kMode != kFwd;
  constexpr int kMats = mats_per_cond(kMode);
  constexpr int per = kThreads;
  const int t = threadIdx.x;
  const int b = blockIdx.x;
  const int kk = k * k;

  // Shared memory: [mats (unless in scratch)] [vec] [red].  Every piece
  // holds an even number of floats, so the doubles stay aligned.
  float* vec = scratch ? smem : smem + (size_t)kMats * kk;
  float* mats = scratch ? scratch + (size_t)b * kMats * kk : smem;
  float* red = vec + (size_t)8 * k;
  float* Dz = mats;           // distances, later W for z
  float* Dx = mats + kk;      // distances, later W for x
  float* Gz = mats + 2 * kk;  // hinge slack s, later dL/dD for z
  float* Gx = mats + 3 * kk;  // dL/dD for x
  double* sqz = reinterpret_cast<double*>(vec);
  double* sqx = sqz + k;
  float* rz = vec + 4 * k;
  float* rx = vec + 5 * k;
  float* cz = vec + 6 * k;  // c_i for z
  float* cx = vec + 7 * k;  // c_i for x
  const float* zb = z + (size_t)b * k * dz;
  const float* xb = x + (size_t)b * k * dx;

  for (int i = t; i < k; i += per) {
    sqz[i] = dot_rows(zb + (size_t)i * dz, zb + (size_t)i * dz, dz);
    sqx[i] = dot_rows(xb + (size_t)i * dx, xb + (size_t)i * dx, dx);
  }
  __syncthreads();

  for (int e = t; e < kk; e += per) {
    const int i = e / k, j = e - (e / k) * k;
    float vz = 0.f, vx = 0.f;
    if (i != j) {
      const double gzij =
          dot_rows(zb + (size_t)i * dz, zb + (size_t)j * dz, dz);
      const double gxij =
          dot_rows(xb + (size_t)i * dx, xb + (size_t)j * dx, dx);
      vz = pair_distance(sqz[i], sqz[j], gzij);
      vx = pair_distance(sqx[i], sqx[j], gxij);
    }
    Dz[e] = vz;
    Dx[e] = vx;
  }
  __syncthreads();

  for (int i = t; i < k; i += per) {
    float sz = 0.f, sx = 0.f;
    for (int j = 0; j < k; ++j) {
      sz += Dz[i * k + j];
      sx += Dx[i * k + j];
    }
    rz[i] = sz;
    rx[i] = sx;
  }
  __syncthreads();

  // The slack on an active pair: 1/M for the joint kernel, g/M (rounded as
  // the plain version rounds g * (1/M)) for the backward.
  float s_on = inv_m;
  if constexpr (kMode == kBwd) s_on = __fmul_rn(g[0], inv_m);
  float hsum = 0.f;
  for (int e = t; e < kk; e += per) {
    const int i = e / k, j = e - (e / k) * k;
    const float nz = row_normalized(Dz[e], rz[i]);
    const float nx = row_normalized(Dx[e], rx[i]);
    const float h = hinge_term(alpha, nz, nx);
    hsum += h;  // the diagonal has D = 0, so h = 0 there
    if constexpr (kGrads) Gz[e] = (h > 0.f && i != j) ? s_on : 0.f;
  }
  if constexpr (kMode != kBwd) {
    const float total = block_sum(hsum, red);
    if (t == 0) partial[b] = total;
  }
  if constexpr (!kGrads) return;
  __syncthreads();

  for (int i = t; i < k; i += per) {
    float accz = 0.f, accx = 0.f;
    for (int j = 0; j < k; ++j) {
      const int e = i * k + j;
      const float s = Gz[e];
      accz += c_term(__fmul_rn(alpha, s), row_normalized(Dz[e], rz[i]));
      accx += c_term(-s, row_normalized(Dx[e], rx[i]));
    }
    cz[i] = accz;
    cx[i] = accx;
  }
  __syncthreads();

  for (int e = t; e < kk; e += per) {
    const int i = e / k, j = e - (e / k) * k;
    const float s = Gz[e];
    const bool valid = i != j;
    Gz[e] = dist_grad(valid, __fmul_rn(alpha, s), cz[i], rz[i]);
    Gx[e] = dist_grad(valid, -s, cx[i], rx[i]);
  }
  __syncthreads();

  // W overwrites D in place: element e is read and written by one thread only.
  for (int e = t; e < kk; e += per) {
    const int i = e / k, j = e - (e / k) * k;
    const int tr = j * k + i;
    const float dzv = Dz[e], dxv = Dx[e];
    Dz[e] = pair_weight(Gz[e], Gz[tr], dzv);
    Dx[e] = pair_weight(Gx[e], Gx[tr], dxv);
  }
  __syncthreads();

  float* gzb = gz + (size_t)b * k * dz;
  float* gxb = gx + (size_t)b * k * dx;
  for (int o = t; o < k * dz; o += per) {
    const int i = o / dz;
    gzb[o] = weighted_diff(Dz + (size_t)i * k, zb, k, dz, i, o - i * dz);
  }
  for (int o = t; o < k * dx; o += per) {
    const int i = o / dx;
    gxb[o] = weighted_diff(Dx + (size_t)i * k, xb, k, dx, i, o - i * dx);
  }
}

// Fixed-order sum of the per-block partials: one block, strided then tree.
__global__ void __launch_bounds__(kThreads)
sum_partials_kernel(const float* __restrict__ partial, int n,
                    float* __restrict__ total) {
  __shared__ float red[kThreads];
  float acc = 0.f;
  for (int i = threadIdx.x; i < n; i += kThreads) acc += partial[i];
  const float s = block_sum(acc, red);
  if (threadIdx.x == 0) total[0] = s;
}

// ---------------------------------------------------- the warp kernel

// The warp kernel's team for one condition: k padded to kp = 8, 16, 32 or
// 64, team_warps warps on it, team_conds teams per block, and the blocks
// per SM its registers are sized for.  At kp = 32 the grad modes take four
// warps a condition (one thread a 2 x 4 tile of each matrix) and 5 blocks
// an SM, as many as their shared memory allows at pod_dp's widths; fwd
// takes two (a 4 x 4 tile: 8 loads for 16 fmas in the Gram loop instead of
// 6 for 8) and 4 blocks, 8 conditions an SM.  Measured at pod_dp's shape
// (ndiv_kernel_ab.py, NVIDIA H100 80GB HBM3, 700 W): fwd on teams of four
// took 0.180-0.194 ms at 5-8 blocks an SM, on teams of two 0.161.  At
// kp = 64 (fwd and bwd only) a team of four would give each thread a 4 x 8
// tile, 32 f64 accumulators: the team takes eight warps (a 2 x 8 tile), so
// the block grows to 256 threads, one condition a block; shared memory
// holds 3 fwd conditions an SM and 2 bwd conditions at imagecond's widths.
// fwd on teams of four (4 x 8 tiles, no spills) took 0.606 ms at 8192
// conditions against 0.546 on teams of eight (ndiv_kernel_ab.py, same card).
__host__ __device__ constexpr int warp_kp(int k) {
  return k <= 8 ? 8 : (k <= 16 ? 16 : (k <= 32 ? 32 : 64));
}
__host__ __device__ constexpr int team_warps(int kp, int mode = kJoint) {
  return kp == 64 ? 8 : (kp == 32 && mode != kFwd ? 4 : 2);
}
__host__ __device__ constexpr int team_conds(int kp, int mode = kJoint) {
  return team_warps(kp, mode) >= 4 ? 1 : 4 / team_warps(kp, mode);
}
__host__ __device__ constexpr int warp_block_threads(int kp, int mode) {
  return 32 * team_warps(kp, mode) * team_conds(kp, mode);
}
__host__ __device__ constexpr int warp_min_blocks(int mode, int kp) {
  return kp == 64 ? (mode == kFwd ? 3 : 2)
                  : (kp == 32 ? (mode == kFwd ? 4 : 5) : 2);
}
// The largest k of each mode's warp kernel: the joint's stops at 32.
__host__ __device__ constexpr int warp_max_k(int mode) {
  return mode == kJoint ? 32 : 64;
}

// Bytes of one condition's slice of shared memory: the rows, transposed
// in f64 [d][kp + 1]; the f32 matrices [kp][kp + 1] (kp (kp + 1) is even,
// so the doubles after them stay aligned): Dz and Dx, and with grads Gz
// and Gx too; sq_z and sq_x in f64; r_z and r_x in f32, and with grads
// each row's two dL/dD values for z and for x and the slack's bits
// [kp][kp / 8] (kp^2 / 8 bytes, a multiple of 8).
__host__ __device__ inline size_t warp_cond_bytes(int mode, int kp, int dz,
                                                  int dx) {
  const size_t s = kp + 1;
  const bool grads = mode != kFwd;
  return 8 * s * (dz + dx) + (grads ? 16 : 8) * (size_t)kp * s +
         16 * (size_t)kp + (grads ? 24 + kp / 8 : 8) * (size_t)kp;
}

size_t warp_smem_bytes(int mode, int k, int dz, int dx) {
  const int kp = warp_kp(k);
  return team_conds(kp, mode) * warp_cond_bytes(mode, kp, dz, dx) +
         warp_block_threads(kp, mode) * sizeof(float);
}

// The dispatch by shape: the layout plays no part.
bool warp_serves(int mode, int k, int dz, int dx) {
  return k >= 2 && k <= warp_max_k(mode) &&
         warp_smem_bytes(mode, k, dz, dx) <= kSmemOptin;
}

// impl: kByShape dispatches as warp_serves says; kTile asks for the tile
// kernel at any shape (the tests' reference for the warp kernel).
enum Impl : int { kByShape = 0, kTile = 1 };

bool runs_warp(int mode, int k, int dz, int dx, int impl) {
  return impl == kByShape && warp_serves(mode, k, dz, dx);
}

// a [k, d] (row-major, device memory) -> at [d][kp + 1] in f64, rows
// k..kp-1 zero.  Consecutive threads read consecutive floats (and write
// rows t kp + 1 doubles apart, free of bank conflicts); each thread issues
// kBatch loads before it stores any, and steps its element's (row,
// column) without dividing.
template <int kT>
__device__ __forceinline__ void stage_rows(const float* __restrict__ a,
                                           double* __restrict__ at, int k,
                                           int kp, int d, int tt) {
  constexpr int kBatch = 8;
  const int s = kp + 1, n = k * d;
  const int di = kT / d, dt = kT - di * d;
  int i = tt / d, t = tt - i * d;
  for (int base = tt; base < n; base += kT * kBatch) {
    float v[kBatch];
#pragma unroll
    for (int r = 0; r < kBatch; ++r)
      if (base + kT * r < n) v[r] = a[base + kT * r];
#pragma unroll
    for (int r = 0; r < kBatch; ++r)
      if (base + kT * r < n) {
        at[t * s + i] = (double)v[r];
        t += dt;
        const bool wrap = t >= d;
        t -= wrap ? d : 0;
        i += di + (wrap ? 1 : 0);
      }
  }
  for (int e = n + tt; e < kp * d; e += kT) {
    const int row = e / d;
    at[(e - row * d) * s + row] = 0.0;
  }
}

// Barrier of one condition's team of kNW warps: named barrier 1 + team
// (0 is __syncthreads').
template <int kNW>
__device__ __forceinline__ void team_sync(int team) {
  asm volatile("bar.sync %0, %1;" ::"r"(1 + team), "r"(32 * kNW) : "memory");
}

// The team's threads form a kR x 8 grid; thread (p, q) owns the entries
// (p + kR u, q + 8 v) of every kp x kp matrix, u < kp / kR, v < kp / 8.
template <int kp, int kNWp = team_warps(kp)>
struct Grid {
  static constexpr int kNW = kNWp;
  static constexpr int kT = 32 * kNW;
  static constexpr int kR = kT / 8;
  static constexpr int kU = kp / kR;
  static constexpr int kV = kp / 8;
  static constexpr int s = kp + 1;  // row stride of the rows and matrices
};

// The thread's tile of the Gram matrix of at, each entry one sequential
// f64 fma chain over t (dot_rows' order): the diagonal is sq bitwise, then
// D off the diagonal.  A warp's loads of a step read 4 and 8 neighbouring
// doubles.
template <int kp, int kNW>
__device__ __forceinline__ void warp_distances(const double* __restrict__ at,
                                               int d, int k, int p, int q,
                                               int team,
                                               double* __restrict__ sq,
                                               float* __restrict__ D) {
  using G = Grid<kp, kNW>;
  double acc[G::kU][G::kV];
#pragma unroll
  for (int u = 0; u < G::kU; ++u)
#pragma unroll
    for (int v = 0; v < G::kV; ++v) acc[u][v] = 0.0;
  for (int t = 0; t < d; ++t) {
    const double* row = at + t * G::s;
    double ai[G::kU], aj[G::kV];
#pragma unroll
    for (int u = 0; u < G::kU; ++u) ai[u] = row[p + G::kR * u];
#pragma unroll
    for (int v = 0; v < G::kV; ++v) aj[v] = row[q + 8 * v];
#pragma unroll
    for (int u = 0; u < G::kU; ++u)
#pragma unroll
      for (int v = 0; v < G::kV; ++v) acc[u][v] = fma(ai[u], aj[v], acc[u][v]);
  }
#pragma unroll
  for (int u = 0; u < G::kU; ++u)
#pragma unroll
    for (int v = 0; v < G::kV; ++v)
      if (p + G::kR * u == q + 8 * v) sq[p + G::kR * u] = acc[u][v];
  team_sync<G::kNW>(team);
#pragma unroll
  for (int u = 0; u < G::kU; ++u)
#pragma unroll
    for (int v = 0; v < G::kV; ++v) {
      const int i = p + G::kR * u, j = q + 8 * v;
      if (i < k && j < k)
        D[i * G::s + j] =
            i != j ? pair_distance(sq[i], sq[j], acc[u][v]) : 0.f;
    }
}

// W [k][kp + 1] in f32 -> f64 in place of the matrix's D and dL/dD
// (W64 aliases them), each thread its own entries.
template <int kp>
__device__ __forceinline__ void warp_weights(float* __restrict__ D,
                                             const float* __restrict__ Gm,
                                             int k, int p, int q, int team) {
  using G = Grid<kp>;
  float w[G::kU][G::kV];
#pragma unroll
  for (int u = 0; u < G::kU; ++u)
#pragma unroll
    for (int v = 0; v < G::kV; ++v) {
      const int i = p + G::kR * u, j = q + 8 * v;
      w[u][v] = (i < k && j < k) ? pair_weight(Gm[i * G::s + j],
                                               Gm[j * G::s + i],
                                               D[i * G::s + j])
                                 : 0.f;
    }
  team_sync<G::kNW>(team);
  double* W64 = reinterpret_cast<double*>(D);
#pragma unroll
  for (int u = 0; u < G::kU; ++u)
#pragma unroll
    for (int v = 0; v < G::kV; ++v) {
      const int i = p + G::kR * u, j = q + 8 * v;
      if (i < k && j < k) W64[i * G::s + j] = (double)w[u][v];
    }
}

// out [k, d] = sum_j W_ij (a_i - a_j) in f64 (weighted_diff's order):
// thread (p, q) of the team's grid owns rows p + kR u and columns
// c0 + q + 8 w of each pass, holding its a_i in registers; each step over
// j loads kU values of W and kC of a_j for 2 kU kC f64 operations.
template <int kp, int kC, bool kWhole>
__device__ __forceinline__ void warp_grads(const double* __restrict__ at,
                                           const double* __restrict__ W64,
                                           int k, int d, int p, int q,
                                           float* __restrict__ out) {
  // kWhole: 8 kC divides d, so no column needs a guard.
  using G = Grid<kp>;
  for (int c0 = 0; c0 < d; c0 += 8 * kC) {
    double acc[G::kU][kC], ai[G::kU][kC];
#pragma unroll
    for (int u = 0; u < G::kU; ++u)
#pragma unroll
      for (int w = 0; w < kC; ++w) {
        const int c = c0 + q + 8 * w;
        ai[u][w] = kWhole || c < d ? at[c * G::s + p + G::kR * u] : 0.0;
        acc[u][w] = 0.0;
      }
    for (int j = 0; j < k; ++j) {
      double wv[G::kU], aj[kC];
#pragma unroll
      for (int u = 0; u < G::kU; ++u) wv[u] = W64[(p + G::kR * u) * G::s + j];
#pragma unroll
      for (int w = 0; w < kC; ++w) {
        const int c = c0 + q + 8 * w;
        aj[w] = kWhole || c < d ? at[c * G::s + j] : 0.0;
      }
#pragma unroll
      for (int u = 0; u < G::kU; ++u)
#pragma unroll
        for (int w = 0; w < kC; ++w)
          acc[u][w] = grad_step(wv[u], ai[u][w], aj[w], acc[u][w]);
    }
#pragma unroll
    for (int u = 0; u < G::kU; ++u)
#pragma unroll
      for (int w = 0; w < kC; ++w) {
        const int i = p + G::kR * u, c = c0 + q + 8 * w;
        if (i < k && (kWhole || c < d))
          out[(size_t)i * d + c] = (float)acc[u][w];
      }
  }
}

// The same for narrow rows (z's dz = 2): one output a thread, on the
// first k d threads, so the others start on x's grads at once.
template <int kp>
__device__ __forceinline__ void warp_grads_narrow(
    const double* __restrict__ at, const double* __restrict__ W64, int k,
    int d, int tt, float* __restrict__ out) {
  constexpr int s = kp + 1;
  for (int o = tt; o < k * d; o += Grid<kp>::kT) {
    const int i = o / d, c = o - (o / d) * d;
    const double ai = at[c * s + i];
    double acc = 0.0;
    for (int j = 0; j < k; ++j)
      acc = grad_step(W64[i * s + j], ai, at[c * s + j], acc);
    out[o] = (float)acc;
  }
}

// A thread's share of one matrix's grads: narrow rows one output a thread,
// wide ones four columns a pass.  No barrier between z's and x's: they
// read only W and the rows.
template <int kp>
__device__ __forceinline__ void warp_grads_of(const double* at,
                                              const double* W64, int k, int d,
                                              int p, int q, int tt,
                                              float* out) {
  if (d <= 8)
    warp_grads_narrow<kp>(at, W64, k, d, tt, out);
  else if (d % 32 == 0)
    warp_grads<kp, 4, true>(at, W64, k, d, p, q, out);
  else
    warp_grads<kp, 4, false>(at, W64, k, d, p, q, out);
}

// ndiv_fwd, ndiv_joint and ndiv_bwd for 2 <= k <= kp: a team of warps per
// condition, each phase on the team's thread grid or one row per thread,
// separated by team_sync.  fwd stops after the hinge; bwd takes the slack
// g / M (rounded as the tile kernel rounds it) where joint takes 1 / M, and
// sums no loss.  Persistent: the grid holds at most as many blocks as are
// resident at once, each walking over conditions; the grid sets no bit of
// the results.
//
// The loss partials: one per condition, so the total's summation tree
// depends only on the shape.  The team that takes a condition sums its
// hinge terms (each thread's entries in order, a fixed lane tree, then the
// team's warps in order) into partial[b], and the last block sums the
// partials in an order set by their count.  Chunks of one condition keep
// the walk's finest grain (at pod_dp's 8192 conditions over 660 resident
// teams, chunks of 2 would take 14 rounds instead of 13, chunks of 4 16)
// and keep no sum live across the grad phases.
template <int kMode, int kp>
__global__ void __launch_bounds__(warp_block_threads(kp, kMode),
                                  warp_min_blocks(kMode, kp))
ndiv_warp_kernel(const float* __restrict__ z, const float* __restrict__ x,
                 const float* __restrict__ g, int batch, int k, int dz,
                 int dx, float alpha, float inv_m,
                 float* __restrict__ partial, float* __restrict__ total,
                 unsigned int* __restrict__ ticket, float* __restrict__ gz,
                 float* __restrict__ gx) {
  using G = Grid<kp, team_warps(kp, kMode)>;
  constexpr bool kGrads = kMode != kFwd;
  constexpr bool kLoss = kMode != kBwd;
  constexpr int conds = team_conds(kp, kMode);
  constexpr int s = G::s;
  constexpr int kBlock = warp_block_threads(kp, kMode);
  static_assert(G::kT * conds == kBlock, "block size");
  static_assert(G::kT >= 2 * kp, "a thread per row of both matrices");
  extern __shared__ double warp_smem[];
  __shared__ bool last_block;
  const int team = threadIdx.x / G::kT, tt = threadIdx.x % G::kT;
  const int p = tt >> 3, q = tt & 7;
  const size_t cond_bytes = warp_cond_bytes(kMode, kp, dz, dx);
  unsigned char* base =
      reinterpret_cast<unsigned char*>(warp_smem) + team * cond_bytes;
  double* zt = reinterpret_cast<double*>(base);
  double* xt = zt + dz * s;
  // W_z (f64) later lies over Dz and Gz, W_x over Dx and Gx; without
  // grads there are only Dz and Dx.
  float* Dz = reinterpret_cast<float*>(xt + dx * s);
  float* Gz = Dz + kp * s;  // z's c terms, later dL/dD for z
  float* Dx = kGrads ? Gz + kp * s : Gz;
  float* Gx = Dx + kp * s;  // x's c terms, later dL/dD for x
  double* sqz = reinterpret_cast<double*>(kGrads ? Gx + kp * s : Gx);
  double* sqx = sqz + kp;
  float* rz = reinterpret_cast<float*>(sqx + kp);
  float* rx = rz + kp;
  float* gdz = rx + kp;       // [2][kp]: a row's dL/dD where its slack is
  float* gdx = gdz + 2 * kp;  // s_on, and where it is 0
  // Bit q of on_bits[i][v]: the slack of entry (i, q + 8 v) is s_on.
  unsigned char* on_bits = reinterpret_cast<unsigned char*>(gdx + 2 * kp);
  float* red = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(warp_smem) + conds * cond_bytes);
  float* team_red = red + team * G::kNW;  // the condition's warp sums

  // The slack on an active pair, as the tile kernel computes it.
  float s_on = inv_m;
  if constexpr (kMode == kBwd) s_on = __fmul_rn(g[0], inv_m);

  for (int b = blockIdx.x * conds + team; b < batch;
       b += gridDim.x * conds) {  // team-uniform: its barriers stay matched
    stage_rows<G::kT>(z + (size_t)b * k * dz, zt, k, kp, dz, tt);
    stage_rows<G::kT>(x + (size_t)b * k * dx, xt, k, kp, dx, tt);
    team_sync<G::kNW>(team);
    warp_distances<kp, G::kNW>(zt, dz, k, p, q, team, sqz, Dz);
    warp_distances<kp, G::kNW>(xt, dx, k, p, q, team, sqx, Dx);
    team_sync<G::kNW>(team);

    // Row sums and c_i: thread i < kp takes row i of z's matrices,
    // thread kp + i row i of x's.
    const int row = tt % kp;
    const bool on_x = tt >= kp;
    if (tt < 2 * kp && row < k) {
      const float* Drow = (on_x ? Dx : Dz) + row * s;
      float sum = 0.f;
      for (int j = 0; j < k; ++j) sum += Drow[j];
      (on_x ? rx : rz)[row] = sum;
    }
    team_sync<G::kNW>(team);

    float hsum = 0.f;  // the thread's hinge terms of this condition
#pragma unroll
    for (int u = 0; u < G::kU; ++u)
#pragma unroll
      for (int v = 0; v < G::kV; ++v) {
        const int i = p + G::kR * u, j = q + 8 * v;
        bool on = false;  // the pair's slack is s_on
        if (i < k && j < k) {
          const int e = i * s + j;
          const float nz = row_normalized(Dz[e], rz[i]);
          const float nx = row_normalized(Dx[e], rx[i]);
          const float h = hinge_term(alpha, nz, nx);
          hsum += h;  // the diagonal has D = 0, so h = 0 there
          if constexpr (kGrads) {
            on = h > 0.f && i != j;
            const float sl = on ? s_on : 0.f;
            Gz[e] = c_term(__fmul_rn(alpha, sl), nz);
            Gx[e] = c_term(-sl, nx);
          }
        }
        if constexpr (kGrads) {
          // Lane 8 (p & 3) + q holds entry (i, q + 8 v) of one of the
          // warp's four rows: each row's byte of the ballot.
          const unsigned bits = __ballot_sync(0xffffffffu, on);
          if (q == 0)
            on_bits[i * G::kV + v] =
                static_cast<unsigned char>(bits >> (8 * (p & 3)));
        }
      }
    // The condition's partial: a fixed lane tree, then the team's warps in
    // order, across the barrier the grad phases need anyway.
    if constexpr (kLoss) {
      for (int off = 16; off > 0; off >>= 1)
        hsum += __shfl_down_sync(0xffffffffu, hsum, off);
      if ((tt & 31) == 0) team_red[tt >> 5] = hsum;
    }
    team_sync<G::kNW>(team);
    if (kLoss && tt == 0) {
      float sum = 0.f;
      for (int w = 0; w < G::kNW; ++w) sum += team_red[w];
      partial[b] = sum;
    }
    if constexpr (!kGrads) continue;

    // c_i, then dL/dD of the row's off-diagonal entries: the slack takes
    // only the values s_on and 0, so a row has two, each computed as the
    // tile kernel computes every entry.
    if (tt < 2 * kp && row < k) {
      const float* Trow = (on_x ? Gx : Gz) + row * s;
      float c = 0.f;
      for (int j = 0; j < k; ++j) c += Trow[j];
      const float r = (on_x ? rx : rz)[row];
      float* gd = on_x ? gdx : gdz;
      const float g_on = on_x ? -s_on : __fmul_rn(alpha, s_on);
      const float g_off = on_x ? -0.f : __fmul_rn(alpha, 0.f);
      gd[row] = dist_grad(true, g_on, c, r);
      gd[kp + row] = dist_grad(true, g_off, c, r);
    }
    team_sync<G::kNW>(team);

#pragma unroll
    for (int u = 0; u < G::kU; ++u)
#pragma unroll
      for (int v = 0; v < G::kV; ++v) {
        const int i = p + G::kR * u, j = q + 8 * v;
        if (i < k && j < k) {
          const int e = i * s + j;
          const bool on = on_bits[i * G::kV + v] >> q & 1;
          const int slot = (on ? 0 : kp) + i;
          Gz[e] = i != j ? gdz[slot] : 0.f;
          Gx[e] = i != j ? gdx[slot] : 0.f;
        }
      }
    team_sync<G::kNW>(team);

    warp_weights<kp>(Dz, Gz, k, p, q, team);
    warp_weights<kp>(Dx, Gx, k, p, q, team);
    team_sync<G::kNW>(team);
    warp_grads_of<kp>(zt, reinterpret_cast<const double*>(Dz), k, dz, p, q,
                      tt, gz + (size_t)b * k * dz);
    warp_grads_of<kp>(xt, reinterpret_cast<const double*>(Dx), k, dx, p, q,
                      tt, gx + (size_t)b * k * dx);
    team_sync<G::kNW>(team);  // the next condition's rows overwrite these
  }
  if constexpr (!kLoss) return;

  // The last block to take a ticket sums the partials in a fixed order
  // (the blocks finish in any order; the sum does not depend on it, nor on
  // the grid) and resets the ticket.
  __threadfence();  // each team's partials, before its block's ticket
  __syncthreads();
  if (threadIdx.x == 0)
    last_block = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  // Thread t sums partials t, t + kBlock, ... in order, its loads made in
  // batches ahead of their adds.
  constexpr int kBatch = 8;
  float acc = 0.f;
  for (int base = threadIdx.x; base < batch;
       base += kBlock * kBatch) {
    float v[kBatch];
#pragma unroll
    for (int r = 0; r < kBatch; ++r) {
      const int i = base + kBlock * r;
      v[r] = i < batch ? __ldcg(partial + i) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < kBatch; ++r)
      if (base + kBlock * r < batch) acc += v[r];
  }
  red[threadIdx.x] = acc;
  __syncthreads();
  for (int w = kBlock / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    total[0] = red[0];
    *ticket = 0u;  // ready for the next launch
  }
}

// The kernel instance for (mode, k), with its shared memory raised past
// 48 KB where it needs more.
template <int kMode, int kp>
cudaError_t warp_kernel_ready(size_t smem) {
  if (smem <= kSmemLimit) return cudaSuccess;
  return cudaFuncSetAttribute(ndiv_warp_kernel<kMode, kp>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// Blocks of one warp-kernel launch on the current device: the conditions'
// blocks, at most as many as are resident at once.  0 on an error.
template <int kMode, int kp>
int warp_blocks_kp(int batch, int k, int dz, int dx) {
  const size_t smem = warp_smem_bytes(kMode, k, dz, dx);
  int dev = 0, sms = 0, per_sm = 0;
  if (warp_kernel_ready<kMode, kp>(smem) != cudaSuccess ||
      cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, ndiv_warp_kernel<kMode, kp>, warp_block_threads(kp, kMode),
          smem) !=
          cudaSuccess)
    return 0;
  const int needed =
      (batch + team_conds(kp, kMode) - 1) / team_conds(kp, kMode);
  const int resident = sms * (per_sm > 0 ? per_sm : 1);
  return needed < resident ? needed : resident;
}

template <int kMode>
int warp_blocks(int batch, int k, int dz, int dx) {
  switch (warp_kp(k)) {
    case 8:
      return warp_blocks_kp<kMode, 8>(batch, k, dz, dx);
    case 16:
      return warp_blocks_kp<kMode, 16>(batch, k, dz, dx);
    case 32:
      return warp_blocks_kp<kMode, 32>(batch, k, dz, dx);
    default:  // kp = 64: fwd and bwd only (warp_max_k)
      if constexpr (kMode != kJoint)
        return warp_blocks_kp<kMode, 64>(batch, k, dz, dx);
      return 0;
  }
}

// ------------------------------------------------------------- launches

size_t mats_floats(int k, int mode) {
  return (size_t)mats_per_cond(mode) * k * k;
}

// sq (2k doubles), r and c (4k floats).
size_t vec_floats(int k) { return (size_t)8 * k; }

bool mats_fit_smem(int k, int mode) {
  return (mats_floats(k, mode) + vec_floats(k) + kThreads) * sizeof(float) <=
         kSmemLimit;
}

struct Args {
  const float* z;
  const float* x;
  const float* g;
  int batch, k, dz, dx;
  float alpha, inv_m;
  float* partial;
  int blocks;  // the warp kernel's grid
  float* total;
  unsigned int* ticket;
  float* gz;
  float* gx;
  float* scratch;
  cudaStream_t stream;
};

template <int kMode>
int launch_tiled(const Args& a) {
  const bool in_smem = mats_fit_smem(a.k, kMode);
  if (!in_smem && a.scratch == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem =
      (vec_floats(a.k) + (in_smem ? mats_floats(a.k, kMode) : 0) + kThreads) *
      sizeof(float);
  ndiv_tile_kernel<kMode><<<a.batch, kThreads, smem, a.stream>>>(
      a.z, a.x, a.g, a.k, a.dz, a.dx, a.alpha, a.inv_m, a.partial, a.gz,
      a.gx, in_smem ? nullptr : a.scratch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || kMode == kBwd) return (int)err;
  sum_partials_kernel<<<1, kThreads, 0, a.stream>>>(a.partial, a.batch,
                                                    a.total);
  return (int)cudaGetLastError();
}

template <int kMode, int kp>
int launch_warp_kp(const Args& a) {
  if ((kMode != kBwd && a.ticket == nullptr) || a.blocks < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = warp_smem_bytes(kMode, a.k, a.dz, a.dx);
  const cudaError_t err = warp_kernel_ready<kMode, kp>(smem);
  if (err != cudaSuccess) return (int)err;
  ndiv_warp_kernel<kMode, kp>
      <<<a.blocks, warp_block_threads(kp, kMode), smem, a.stream>>>(
          a.z, a.x, a.g, a.batch, a.k, a.dz, a.dx, a.alpha, a.inv_m,
          a.partial, a.total, a.ticket, a.gz, a.gx);
  return (int)cudaGetLastError();
}

template <int kMode>
int launch_warp(const Args& a) {
  switch (warp_kp(a.k)) {
    case 8:
      return launch_warp_kp<kMode, 8>(a);
    case 16:
      return launch_warp_kp<kMode, 16>(a);
    case 32:
      return launch_warp_kp<kMode, 32>(a);
    default:  // kp = 64: fwd and bwd only (warp_max_k)
      if constexpr (kMode != kJoint) return launch_warp_kp<kMode, 64>(a);
      return (int)cudaErrorInvalidValue;
  }
}

// The dispatch by shape (runs_warp): calls the warp kernel serves go to it,
// everything else, and every call with impl = kTile, to the tile kernel.
template <int kMode>
int launch(int impl, const Args& a) {
  if (a.batch < 1 || a.k < 2 || a.dz < 1 || a.dx < 1 ||
      (impl != kByShape && impl != kTile))
    return (int)cudaErrorInvalidValue;
  if (runs_warp(kMode, a.k, a.dz, a.dx, impl)) return launch_warp<kMode>(a);
  return launch_tiled<kMode>(a);
}

}  // namespace

extern "C" {

// 1 when a call of this mode (0 = fwd, 1 = joint, 2 = bwd) runs the warp
// kernel at this shape, 0 for the tile kernel.
int ndiv_warp_serves(int mode, int k, int dz, int dx) {
  return warp_serves(mode, k, dz, dx) ? 1 : 0;
}

// The launches below take impl (0: the dispatch by shape, 1: the tile
// kernel at any shape).

// Blocks of one launch of this mode (either kernel) on the current device.
// 0 on an error.
int ndiv_blocks(int mode, int batch, int k, int dz, int dx, int impl) {
  if (!runs_warp(mode, k, dz, dx, impl)) return batch;
  switch (mode) {
    case kFwd:
      return warp_blocks<kFwd>(batch, k, dz, dx);
    case kJoint:
      return warp_blocks<kJoint>(batch, k, dz, dx);
    default:
      return warp_blocks<kBwd>(batch, k, dz, dx);
  }
}

// Floats of global scratch each condition needs (0 when shared memory
// holds it, and always under the warp kernel).
long long ndiv_scratch_floats(int mode, int k, int dz, int dx, int impl) {
  return runs_warp(mode, k, dz, dx, impl) || mats_fit_smem(k, mode)
             ? 0
             : (long long)mats_floats(k, mode);
}

// Hinge sum (total [1], partial [ndiv_partials]) and unit-cotangent grads
// gz, gx.  blocks: the warp kernel's grid (ndiv_blocks; any count >= 1
// gives the same bits).  ticket: one zeroed unsigned int in device memory,
// owned by the stream (the warp kernel leaves it zero again).
int ndiv_joint(const float* z, const float* x, int batch, int k, int dz,
               int dx, float alpha, float inv_m, int impl,
               float* partial, int blocks, float* total, unsigned int* ticket,
               float* gz, float* gx, float* scratch, void* stream) {
  return launch<kJoint>(impl,
                        Args{z, x, nullptr, batch, k, dz, dx, alpha, inv_m,
                             partial, blocks, total, ticket, gz, gx, scratch,
                             static_cast<cudaStream_t>(stream)});
}

// Hinge sum only (total [1], partial, blocks and ticket as for ndiv_joint).
int ndiv_fwd(const float* z, const float* x, int batch, int k, int dz, int dx,
             float alpha, int impl, float* partial, int blocks,
             float* total, unsigned int* ticket, float* scratch,
             void* stream) {
  return launch<kFwd>(impl,
                      Args{z, x, nullptr, batch, k, dz, dx, alpha, 0.f,
                           partial, blocks, total, ticket, nullptr, nullptr,
                           scratch, static_cast<cudaStream_t>(stream)});
}

// Grads gz, gx at the cotangent g [1] (device memory); blocks as for
// ndiv_joint.
int ndiv_bwd(const float* z, const float* x, const float* g, int batch, int k,
             int dz, int dx, float alpha, float inv_m, int impl, int blocks, float* gz, float* gx, float* scratch,
             void* stream) {
  return launch<kBwd>(impl,
                      Args{z, x, g, batch, k, dz, dx, alpha, inv_m, nullptr,
                           blocks, nullptr, nullptr, gz, gx, scratch,
                           static_cast<cudaStream_t>(stream)});
}

const char* ndiv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
