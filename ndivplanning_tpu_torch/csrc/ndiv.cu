// NDiv hinge loss kernels for Hopper (sm_90a), bound to Python via ctypes.
//
// Replaces the Pallas TPU kernels of ndivplanning_tpu/ops/ndiv_pallas.py:
//   ndiv_joint -> _joint_kernel_block (hinge sum + unit-cotangent grads, one pass)
//   ndiv_fwd   -> _fwd_kernel_block and the packed _fwd_kernel (hinge sum only)
//   ndiv_bwd   -> _bwd_kernel_block and the packed _bwd_kernel (grads at an
//                 upstream cotangent g, recomputing the forward)
// and the three TPU layouts "block", "group" and "packed" as tilings of one
// kernel (below).
//
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
// at the imagecond shape (B=512, k=8, dz=2, dx=64) a grad kernel reads z
// and x once (512*8*66*4 B = 1.08 MB) and writes the grads (another
// 1.08 MB): ~2.2 MB, ~0.65 us; its ~11 MFLOP in f64 and ~1 MFLOP in f32
// take ~0.34 us.  So the bound is bytes, and below the few microseconds a
// launch costs: the kernels are launch-latency bound on the train step.
//
// Design against that bound: one launch does all the work of a loss (and
// its grads), plus one tiny fixed-order reduction launch for the loss, and
// nothing of the k x k intermediates reaches device memory while they fit
// in shared memory.  f32 arithmetic, no tensor cores, except in two places
// that would cancel: the generator's samples of one condition can sit ~1e-3
// apart at |x|^2 ~ 16, where the Gram form in f32 keeps almost no digit of
// D (and rowsum(W) a_i - (W a)_i none of the grad).  So the norms and dot
// products accumulate in f64 and D is rounded to f32 only at the end, and
// the grad sums W_ij (a_i - a_j) in f64.
//
// Tilings.  On the TPU "block" gives each condition its own [kp, kp] Gram
// (kp = k rounded up to 8), "group" packs 128 // kp conditions into one
// [128, 128] Gram and "packed" 256 // kp into one [256, 256] Gram, under a
// block-diagonal mask: the same function on other lane layouts.  Here the
// tile's row count is the kernel's template parameter kTileRows (0 for
// block), and a thread block holds conds = max(1, kTileRows / kp)
// conditions (1, 16 and 32 at k = 8), each on its own slice of the block's
// 256 threads and its own slice of shared memory.  Every per-condition value
// is computed by one thread in a fixed sequential order that does not
// depend on the slice's width, so the grads of the three tilings are
// bitwise equal; only the loss's summation tree differs (each block sums
// its conditions' hinge terms).  Determinism: each block writes one partial
// and a second one-block kernel sums the partials in a fixed order -- no
// float atomics, so repeated launches are bitwise equal.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSublane = 8;
constexpr size_t kSmemLimit = 48 * 1024;

enum Mode : int { kFwd = 0, kJoint = 1, kBwd = 2 };

__host__ __device__ constexpr int conds_per_block(int tile_rows, int k) {
  const int kp = (k + kSublane - 1) / kSublane * kSublane;
  return tile_rows / kp > 1 ? tile_rows / kp : 1;
}

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

// sum_j W_ij (a_i - a_j)[c] in f64, for row i of W and column c of a [k, d].
__device__ __forceinline__ float weighted_diff(const float* __restrict__ w,
                                               const float* __restrict__ a,
                                               int k, int d, int i, int c) {
  const double ai = a[(size_t)i * d + c];
  double acc = 0.0;
  for (int j = 0; j < k; ++j)
    acc = fma((double)w[j], ai - (double)a[(size_t)j * d + c], acc);
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

// One thread block per `conds` conditions.  Each phase is a loop over one
// condition's elements on that condition's `per` threads, guarded by
// `active`; the barriers between phases are outside the guard, so every
// thread of the block reaches them.
template <int kMode, int kTileRows>
__global__ void __launch_bounds__(kThreads)
ndiv_tile_kernel(const float* __restrict__ z, const float* __restrict__ x,
                 const float* __restrict__ g, int batch, int k, int dz, int dx,
                 float alpha, float inv_m, float* __restrict__ partial,
                 float* __restrict__ gz, float* __restrict__ gx,
                 float* __restrict__ scratch) {
  extern __shared__ float smem[];
  constexpr bool kGrads = kMode != kFwd;
  constexpr int kMats = mats_per_cond(kMode);
  const int conds = conds_per_block(kTileRows, k);
  const int per = kThreads / conds;  // threads per condition
  const int tid = threadIdx.x;
  const int c = tid / per;  // == conds for the block's leftover threads
  const int t = tid - c * per;
  const int b = blockIdx.x * conds + c;
  const bool active = c < conds && b < batch;
  const int slot = active ? c : 0;
  const int kk = k * k;

  // Shared memory: [conds x mats (unless in scratch)] [conds x vec] [red].
  // Every piece holds an even number of floats, so the doubles stay aligned.
  float* vecs = scratch ? smem : smem + (size_t)conds * kMats * kk;
  float* mats = scratch ? scratch + (size_t)(active ? b : 0) * kMats * kk
                        : smem + (size_t)slot * kMats * kk;
  float* vec = vecs + (size_t)slot * 8 * k;
  float* red = vecs + (size_t)conds * 8 * k;
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
  const float* zb = z + (size_t)(active ? b : 0) * k * dz;
  const float* xb = x + (size_t)(active ? b : 0) * k * dx;

  if (active) {
    for (int i = t; i < k; i += per) {
      sqz[i] = dot_rows(zb + (size_t)i * dz, zb + (size_t)i * dz, dz);
      sqx[i] = dot_rows(xb + (size_t)i * dx, xb + (size_t)i * dx, dx);
    }
  }
  __syncthreads();

  if (active) {
    for (int e = t; e < kk; e += per) {
      const int i = e / k, j = e - (e / k) * k;
      float vz = 0.f, vx = 0.f;
      if (i != j) {
        const double gzij =
            dot_rows(zb + (size_t)i * dz, zb + (size_t)j * dz, dz);
        const double gxij =
            dot_rows(xb + (size_t)i * dx, xb + (size_t)j * dx, dx);
        vz = (float)sqrt(fmax((sqz[i] + sqz[j]) - 2.0 * gzij, 0.0));
        vx = (float)sqrt(fmax((sqx[i] + sqx[j]) - 2.0 * gxij, 0.0));
      }
      Dz[e] = vz;
      Dx[e] = vx;
    }
  }
  __syncthreads();

  if (active) {
    for (int i = t; i < k; i += per) {
      float sz = 0.f, sx = 0.f;
      for (int j = 0; j < k; ++j) {
        sz += Dz[i * k + j];
        sx += Dx[i * k + j];
      }
      rz[i] = sz;
      rx[i] = sx;
    }
  }
  __syncthreads();

  // The slack on an active pair: 1/M for the joint kernel, g/M (rounded as
  // the plain version rounds g * (1/M)) for the backward.
  float s_on = inv_m;
  if constexpr (kMode == kBwd) s_on = __fmul_rn(g[0], inv_m);
  float hsum = 0.f;
  if (active) {
    for (int e = t; e < kk; e += per) {
      const int i = e / k, j = e - (e / k) * k;
      const float nz = rz[i] > 0.f ? Dz[e] / rz[i] : 0.f;
      const float nx = rx[i] > 0.f ? Dx[e] / rx[i] : 0.f;
      // __fmul_rn keeps the product rounded on its own (no FMA
      // contraction), as the plain version computes it.
      const float h = fmaxf(__fmul_rn(alpha, nz) - nx, 0.f);
      hsum += h;  // the diagonal has D = 0, so h = 0 there
      if constexpr (kGrads) Gz[e] = (h > 0.f && i != j) ? s_on : 0.f;
    }
  }
  if constexpr (kMode != kBwd) {
    const float total = block_sum(hsum, red);
    if (tid == 0) partial[blockIdx.x] = total;
  }
  if constexpr (!kGrads) return;
  __syncthreads();

  if (active) {
    for (int i = t; i < k; i += per) {
      float accz = 0.f, accx = 0.f;
      for (int j = 0; j < k; ++j) {
        const int e = i * k + j;
        const float s = Gz[e];
        const float nz = rz[i] > 0.f ? Dz[e] / rz[i] : 0.f;
        const float nx = rx[i] > 0.f ? Dx[e] / rx[i] : 0.f;
        accz += __fmul_rn(__fmul_rn(alpha, s), nz);
        accx += __fmul_rn(-s, nx);
      }
      cz[i] = accz;
      cx[i] = accx;
    }
  }
  __syncthreads();

  if (active) {
    for (int e = t; e < kk; e += per) {
      const int i = e / k, j = e - (e / k) * k;
      const float s = Gz[e];
      const bool valid = i != j;
      Gz[e] = (valid && rz[i] > 0.f) ? (__fmul_rn(alpha, s) - cz[i]) / rz[i]
                                     : 0.f;
      Gx[e] = (valid && rx[i] > 0.f) ? (-s - cx[i]) / rx[i] : 0.f;
    }
  }
  __syncthreads();

  // W overwrites D in place: element e is read and written by one thread only.
  if (active) {
    for (int e = t; e < kk; e += per) {
      const int i = e / k, j = e - (e / k) * k;
      const int tr = j * k + i;
      const float dzv = Dz[e], dxv = Dx[e];
      Dz[e] = dzv > 0.f ? (Gz[e] + Gz[tr]) / dzv : 0.f;
      Dx[e] = dxv > 0.f ? (Gx[e] + Gx[tr]) / dxv : 0.f;
    }
  }
  __syncthreads();

  if (active) {
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

size_t mats_floats(int k, int mode) {
  return (size_t)mats_per_cond(mode) * k * k;
}

// sq (2k doubles), r and c (4k floats).
size_t vec_floats(int k) { return (size_t)8 * k; }

bool mats_fit_smem(int k, int mode, int tile_rows) {
  const size_t conds = conds_per_block(tile_rows, k);
  return (conds * (mats_floats(k, mode) + vec_floats(k)) + kThreads) *
             sizeof(float) <= kSmemLimit;
}

int grid_blocks(int batch, int k, int tile_rows) {
  const int conds = conds_per_block(tile_rows, k);
  return (batch + conds - 1) / conds;
}

struct Args {
  const float* z;
  const float* x;
  const float* g;
  int batch, k, dz, dx;
  float alpha, inv_m;
  float* partial;
  float* total;
  float* gz;
  float* gx;
  float* scratch;
  cudaStream_t stream;
};

template <int kMode, int kTileRows>
int launch_tiled(const Args& a) {
  const bool in_smem = mats_fit_smem(a.k, kMode, kTileRows);
  if (!in_smem && a.scratch == nullptr) return (int)cudaErrorInvalidValue;
  const size_t conds = conds_per_block(kTileRows, a.k);
  const size_t smem =
      (conds * (vec_floats(a.k) + (in_smem ? mats_floats(a.k, kMode) : 0)) +
       kThreads) * sizeof(float);
  const int blocks = grid_blocks(a.batch, a.k, kTileRows);
  ndiv_tile_kernel<kMode, kTileRows><<<blocks, kThreads, smem, a.stream>>>(
      a.z, a.x, a.g, a.batch, a.k, a.dz, a.dx, a.alpha, a.inv_m, a.partial,
      a.gz, a.gx, in_smem ? nullptr : a.scratch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || kMode == kBwd) return (int)err;
  sum_partials_kernel<<<1, kThreads, 0, a.stream>>>(a.partial, blocks,
                                                    a.total);
  return (int)cudaGetLastError();
}

template <int kMode>
int launch(int tile_rows, const Args& a) {
  if (a.batch < 1 || a.k < 2 || a.dz < 1 || a.dx < 1)
    return (int)cudaErrorInvalidValue;
  switch (tile_rows) {
    case 0:
      return launch_tiled<kMode, 0>(a);
    case 128:
      return launch_tiled<kMode, 128>(a);
    case 256:
      return launch_tiled<kMode, 256>(a);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Blocks of one launch, hence the length of the partials buffer.
int ndiv_grid_blocks(int batch, int k, int tile_rows) {
  return grid_blocks(batch, k, tile_rows);
}

// Floats of global scratch each condition needs (0 when shared memory
// holds it); mode 0 = fwd, 1 = joint, 2 = bwd.
long long ndiv_scratch_floats(int k, int mode, int tile_rows) {
  return mats_fit_smem(k, mode, tile_rows) ? 0
                                           : (long long)mats_floats(k, mode);
}

// Hinge sum (total [1], partial [blocks]) and unit-cotangent grads gz, gx.
int ndiv_joint(const float* z, const float* x, int batch, int k, int dz,
               int dx, float alpha, float inv_m, int tile_rows,
               float* partial, float* total, float* gz, float* gx,
               float* scratch, void* stream) {
  return launch<kJoint>(tile_rows, Args{z, x, nullptr, batch, k, dz, dx,
                                        alpha, inv_m, partial, total, gz, gx,
                                        scratch,
                                        static_cast<cudaStream_t>(stream)});
}

// Hinge sum only (total [1], partial [blocks]).
int ndiv_fwd(const float* z, const float* x, int batch, int k, int dz, int dx,
             float alpha, int tile_rows, float* partial, float* total,
             float* scratch, void* stream) {
  return launch<kFwd>(tile_rows, Args{z, x, nullptr, batch, k, dz, dx, alpha,
                                      0.f, partial, total, nullptr, nullptr,
                                      scratch,
                                      static_cast<cudaStream_t>(stream)});
}

// Grads gz, gx at the cotangent g [1] (device memory).
int ndiv_bwd(const float* z, const float* x, const float* g, int batch, int k,
             int dz, int dx, float alpha, float inv_m, int tile_rows,
             float* gz, float* gx, float* scratch, void* stream) {
  return launch<kBwd>(tile_rows, Args{z, x, g, batch, k, dz, dx, alpha, inv_m,
                                      nullptr, nullptr, gz, gx, scratch,
                                      static_cast<cudaStream_t>(stream)});
}

const char* ndiv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
