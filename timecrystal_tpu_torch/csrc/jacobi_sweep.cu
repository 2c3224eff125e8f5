// One-sided complex Jacobi for Hopper (sm_90a): the tournament sweep, one
// launch per sweep, and the whole V-accumulating sweep loop of one matrix
// resident in shared memory, one launch per SVD.
//
// Two kernel templates:
//   * jacobi_sweep_kernel<T, kWithV>, one sweep per launch.  kWithV = false
//     replaces timecrystal_tpu/ops/pallas/jacobi_svd.py::_jacobi_sweep_kernel
//     (:159), the V-free sweep that jacobi_sv runs on theta^H; kWithV = true
//     replaces ::_jacobi_sweep_v_kernel (:75), the same sweep that also
//     rotates the accumulator V (V0 = I) -- jacobi_svd's full (U, S, Vh), run
//     on theta itself.  The host wrapper (ops/jacobi_svd.py) takes the batch
//     max of the measure and decides whether to launch another sweep, as the
//     JAX while_loop does.
//   * jacobi_svd_resident_kernel<T, kGroup> also replaces
//     ::_jacobi_sweep_v_kernel, together with the while_loop around it
//     (jacobi_svd.py:882-894): one launch runs every sweep of one matrix and
//     tests the exit rule itself.
// Both compute what the Pallas kernels compute:
//   * column norms recomputed fresh at sweep start, then carried through
//     the sweep incrementally (a' = a - t|c|, b' = b + t|c|);
//   * n-1 steps; each orthogonalizes all n/2 column pairs with the complex
//     Givens rotation of _pair_rotation (sign at tau = 0 taken POSITIVE,
//     |c| guarded at 1e-30); with V the same rotation (cs, w1, w2) is
//     applied to the pair's two rows of V;
//   * the sweep's convergence measure max_pairs |c|^2 / maxn2^2, maxn2 the
//     sweep-start max column norm^2;
//   * the resident kernel stops once (float) measure < threshold, the
//     float32 tol^2 the host passes (the host loop's rule, bit for bit), or
//     after max_sweeps, and writes the number of sweeps it ran.
//
// Precision: rows are stored in the input precision, and all arithmetic --
// norms, pair overlaps, rotation parameters and the rotated values -- is
// done in double (Acc below), each rotated value rounded once on store.
// For complex64 input that is more accurate than the Pallas kernel's
// float32 arithmetic, and it makes the result independent of how the
// compiler contracts float32 multiply-adds: on logspace(0,-7) spectra at
// n = 512 the 12-sweep S error sits near the 5e-5 * sigma_max acceptance
// bound, and float32 rounding paths land on either side of it.  The plain
// twins (_jacobi_sweep_torch, _jacobi_sweep_v_torch) do the same arithmetic.
//
// Layout: X [B, n, len] row-major, one row per column being orthogonalized,
// so every "column" is a contiguous, coalesced row.  jacobi_sv passes
// X = conj(theta) (rows = columns of theta^H); jacobi_svd passes
// X = theta^T (rows = columns of theta) and V as W = V^T [B, n, n] (row j =
// column j of V), so V's columns rotate exactly like X's rows.  Complex
// numbers are interleaved (float2 / double2), torch's complex64 /
// complex128 layout.
//
// Tournament as an index schedule: sched [n-1, n] int32 holds, for each
// step, which row sits in each L|R slot (slots 0..k-1 = L, k..n-1 = R).  The
// host builds it by replaying the Pallas kernel's concatenate cycle, so the
// L/R roles -- which fix the rotation's sign convention -- match exactly.
// Rows never move in memory; after n-1 steps the arrangement is back at the
// start, as in the Pallas kernel.
//
// FLOPs: (n-1) (n/2) (28 len + 20 n [with V]) per matrix and sweep -- per
// element, 8 for the overlap and 2 x (2 + 6 + 2) for rotate_rows' two
// outputs.  The least time for the work is the larger of bytes / 3.35 TB/s
// (each matrix read and written once) and FLOPs over the card's peak.
//
// Design and bound of the per-sweep kernel: one CTA per matrix, one launch
// per sweep.  Warps loop over the pairs of a step (a warp-reduced dot
// product for c, then the rotation of the two rows, and with V of the two
// V rows), with __syncthreads() between steps.  Rows stay in device memory /
// L2 (an n = 512 complex64 matrix is 2 MiB, more than an SM's 227 KB of
// shared memory); only the norms live in shared memory.  Each step reads
// every row twice (the second read mostly from L1) and writes it once, so
// the kernel is bound by L2 / device-memory bytes per step and by the n-1
// dependent steps.  With one CTA per matrix a call of 20 matrices (the
// single-chain leg) keeps 20 of the 132 SMs busy.  It serves every call the
// resident kernel does not take: batches (the exit reads the batch max, and
// at batch 320 the CTAs are not all resident at once, so no CTA can wait for
// the others' measures) and matrices too large for one SM.
//
// Design and bound of the resident kernel: TDVP's split is one
// [2 chi, 2 chi] matrix per call, so the per-sweep kernel ran it on one SM
// with its rows in L2 (each of the 2 chi - 1 dependent steps a round trip)
// and one host read of the measure per sweep.  The resident kernel instead
//   * loads X once into dynamic shared memory (plain coalesced 16-byte
//     loads: the matrix is read once per call, so TMA or cp.async would buy
//     nothing) and builds W = I there, keeps both for every sweep and writes
//     them back once;
//   * gives every pair of a step its own group of kGroup lanes (16 up to
//     n = 96, 768 threads; 8 above, so that n up to 192 stays within 768
//     threads and __launch_bounds__ leaves 80 registers a thread): the
//     overlap is a shuffle reduction inside the group, the rotation
//     parameters are computed redundantly by the group's lanes, and a step
//     is one round ended by one __syncthreads();
//   * reads sched through the read-only path, the next step's two indices
//     loaded during the current step (at n = 112 the schedule would take
//     50 KB of the shared memory X and W need);
//   * reduces the sweep's measure over the warps in shared memory, lets
//     thread 0 decide, and broadcasts the decision before the next sweep, so
//     the loop and its exit run on the device with no host read.
// It takes a call when B == 1 and n (len + n) itemsize + (n + 32) 8 bytes
// fit in the 232448 bytes of shared memory one block can use: complex64 up
// to n = 120 (chi = 60), complex128 up to n = 84.  Above 48 KB a launch needs
// cudaFuncSetAttribute(..., cudaFuncAttributeMaxDynamicSharedMemorySize)
// first; a launch that asks for more than the attribute allows is refused
// and never runs, so the C entry returns cudaGetLastError() and the wrapper
// raises on it.  Its floor is the work of one SM: batch one cannot use the
// other 131, so the card-wide bound (FLOPs / 67 TFLOP/s) is out of reach,
// and the double arithmetic caps it at the per-SM FP64 rate (34 TFLOP/s /
// 132): 21.0 MFLOP per sweep at [1, 96, 96], ~82 us.  For complex64 the
// float <-> double conversions come on top: 20 per element of a pair and
// step (12 for the X rows: 4 for the overlap, 4 in and 4 out in the
// rotation; 8 for the W rows), at a quarter of the FP64 FMA rate on compute
// capability 9.0 (16 per clock and SM).  No tensor cores: a pair rotation is
// a 2 x 2 transform of two rows, not a matrix product (blocked Jacobi with
// GEMM-applied rotations is another algorithm, with another rotation
// order).  A two-CTA cluster holding X and W apart would halve the per-SM
// work and reach n ~ 168; it is not done here.

#include <cuda_runtime.h>

namespace {

using Acc = double;

template <typename T> struct Complex2;
template <> struct Complex2<float> { using type = float2; };
template <> struct Complex2<double> { using type = double2; };

constexpr int kMaxWarps = 16;
constexpr int kResidentMaxThreads = 768;
constexpr int kMaxSharedBytes = 232448;   // one block's shared memory, sm_90

// sum over the kLanes lanes of a group (the lanes set in mask); xor offsets
// below kLanes stay inside an aligned group
template <int kLanes = 32>
__device__ __forceinline__ Acc group_sum(Acc v, unsigned mask = 0xffffffffu) {
  for (int o = kLanes / 2; o > 0; o >>= 1) v += __shfl_xor_sync(mask, v, o);
  return v;
}

__device__ __forceinline__ Acc warp_max(Acc v) {
  for (int o = 16; o > 0; o >>= 1) v = fmax(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// this lane's share of |row|^2, lanes striding the row by kStride
template <typename T, int kStride>
__device__ __forceinline__ Acc row_norm2(const typename Complex2<T>::type* row,
                                         int len, int lane) {
  Acc s = 0.0;
  for (int i = lane; i < len; i += kStride) {
    const typename Complex2<T>::type v = row[i];
    s += static_cast<Acc>(v.x) * v.x + static_cast<Acc>(v.y) * v.y;
  }
  return s;
}

// this lane's share of c = <u, v> = sum conj(u) v
template <typename T, int kStride>
__device__ __forceinline__ void row_overlap(const typename Complex2<T>::type* u_row,
                                            const typename Complex2<T>::type* v_row,
                                            int len, int lane, Acc& c_re, Acc& c_im) {
  c_re = 0.0;
  c_im = 0.0;
  for (int i = lane; i < len; i += kStride) {
    const typename Complex2<T>::type u = u_row[i], v = v_row[i];
    c_re += static_cast<Acc>(u.x) * v.x + static_cast<Acc>(u.y) * v.y;
    c_im += static_cast<Acc>(u.x) * v.y - static_cast<Acc>(u.y) * v.x;
  }
}

// _pair_rotation (ops/jacobi_svd.py): u' = cs u - w1 v ; v' = w2 u + cs v,
// with w1 = sn conj(ph), w2 = sn ph, and the norms' update t |c|
struct Rotation {
  Acc cs, w1_re, w1_im, w2_re, w2_im, t, absc;
};

__device__ __forceinline__ Rotation pair_rotation(Acc a, Acc b, Acc c_re,
                                                  Acc c_im, Acc abs2c) {
  Rotation q;
  q.absc = sqrt(abs2c);
  const bool safe = q.absc > 1e-30;
  const Acc tau = safe ? (b - a) / fmax(2.0 * q.absc, 1e-30) : 0.0;
  const Acc sgn = tau >= 0.0 ? 1.0 : -1.0;
  q.t = sgn / (fabs(tau) + sqrt(1.0 + tau * tau));
  q.t = safe ? q.t : 0.0;
  q.cs = 1.0 / sqrt(1.0 + q.t * q.t);
  const Acc sn = q.cs * q.t;
  const Acc ph_re = safe ? c_re / fmax(q.absc, 1e-30) : 1.0;
  const Acc ph_im = safe ? c_im / fmax(q.absc, 1e-30) : 0.0;
  q.w1_re = sn * ph_re;
  q.w1_im = -sn * ph_im;
  q.w2_re = sn * ph_re;
  q.w2_im = sn * ph_im;
  return q;
}

// u' = cs u - w1 v ; v' = w2 u + cs v over rows of length len, formed in
// Acc and stored as T; lanes stride the row by kStride.
template <typename T, int kStride = 32>
__device__ __forceinline__ void rotate_rows(typename Complex2<T>::type* u_row,
                                            typename Complex2<T>::type* v_row,
                                            int len, int lane, Acc cs, Acc w1_re,
                                            Acc w1_im, Acc w2_re, Acc w2_im) {
  using C2 = typename Complex2<T>::type;
  for (int i = lane; i < len; i += kStride) {
    const C2 u = u_row[i], v = v_row[i];
    const Acc ux = u.x, uy = u.y, vx = v.x, vy = v.y;
    C2 nu, nv;
    nu.x = static_cast<T>(cs * ux - (w1_re * vx - w1_im * vy));
    nu.y = static_cast<T>(cs * uy - (w1_re * vy + w1_im * vx));
    nv.x = static_cast<T>((w2_re * ux - w2_im * uy) + cs * vx);
    nv.y = static_cast<T>((w2_re * uy + w2_im * ux) + cs * vy);
    u_row[i] = nu;
    v_row[i] = nv;
  }
}

template <typename T, bool kWithV>
__global__ void jacobi_sweep_kernel(typename Complex2<T>::type* __restrict__ X,
                                    typename Complex2<T>::type* __restrict__ V,
                                    const int* __restrict__ sched,
                                    Acc* __restrict__ measure, int n, int len) {
  using C2 = typename Complex2<T>::type;
  extern __shared__ Acc smem[];
  Acc* norms = smem;       // [n], indexed by row
  Acc* red = smem + n;     // [kMaxWarps]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int k = n / 2;
  C2* A = X + static_cast<size_t>(blockIdx.x) * n * len;
  C2* Vb = kWithV ? V + static_cast<size_t>(blockIdx.x) * n * n : nullptr;

  // fresh column norms at sweep start
  for (int r = warp; r < n; r += nwarps) {
    const Acc s = group_sum(row_norm2<T, 32>(A + static_cast<size_t>(r) * len,
                                             len, lane));
    if (lane == 0) norms[r] = s;
  }
  __syncthreads();
  Acc maxn2 = 0.0;
  for (int r = 0; r < n; ++r) maxn2 = fmax(maxn2, norms[r]);
  const Acc inv_maxn2_sq = 1.0 / fmax(maxn2 * maxn2, 1e-30);
  Acc run_max = 0.0;
  __syncthreads();  // every warp has read the norms before step 0 rewrites them

  for (int t = 0; t < n - 1; ++t) {
    const int* slot = sched + static_cast<size_t>(t) * n;
    for (int p = warp; p < k; p += nwarps) {
      const int l = slot[p];
      const int r = slot[k + p];
      C2* u_row = A + static_cast<size_t>(l) * len;
      C2* v_row = A + static_cast<size_t>(r) * len;
      const Acc a = norms[l];
      const Acc b = norms[r];
      Acc c_re, c_im;
      row_overlap<T, 32>(u_row, v_row, len, lane, c_re, c_im);
      c_re = group_sum(c_re);
      c_im = group_sum(c_im);
      const Acc abs2c = c_re * c_re + c_im * c_im;
      run_max = fmax(run_max, abs2c * inv_maxn2_sq);

      const Rotation q = pair_rotation(a, b, c_re, c_im, abs2c);
      rotate_rows<T>(u_row, v_row, len, lane, q.cs, q.w1_re, q.w1_im, q.w2_re,
                     q.w2_im);
      if constexpr (kWithV) {
        rotate_rows<T>(Vb + static_cast<size_t>(l) * n,
                       Vb + static_cast<size_t>(r) * n, n, lane, q.cs, q.w1_re,
                       q.w1_im, q.w2_re, q.w2_im);
      }
      __syncwarp();  // every lane has read a, b before lane 0 overwrites them
      if (lane == 0) {
        norms[l] = a - q.t * q.absc;
        norms[r] = b + q.t * q.absc;
      }
    }
    __syncthreads();  // the next step pairs rows written by other warps
  }

  run_max = warp_max(run_max);
  if (lane == 0) red[warp] = run_max;
  __syncthreads();
  if (threadIdx.x == 0) {
    Acc m = 0.0;
    for (int w = 0; w < nwarps; ++w) m = fmax(m, red[w]);
    measure[blockIdx.x] = m;
  }
}

template <typename T, bool kWithV>
int launch(void* X, void* V, const void* sched, void* measure, int batch, int n,
           int len, void* stream) {
  const int k = n / 2;
  const int warps = k < kMaxWarps ? k : kMaxWarps;
  const size_t shmem = static_cast<size_t>(n + kMaxWarps) * sizeof(Acc);
  using C2 = typename Complex2<T>::type;
  jacobi_sweep_kernel<T, kWithV>
      <<<batch, 32 * warps, shmem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<C2*>(X), static_cast<C2*>(V), static_cast<const int*>(sched),
          static_cast<Acc*>(measure), n, len);
  return static_cast<int>(cudaGetLastError());
}

// Shared memory of the resident kernel: X [n, len] and W [n, n] in T, the
// norms [n] and the measure's reduction scratch [32] in Acc.
template <typename T>
size_t resident_shmem_bytes(int n, int len) {
  using C2 = typename Complex2<T>::type;
  return static_cast<size_t>(n) * (len + n) * sizeof(C2) +
         static_cast<size_t>(n + 32) * sizeof(Acc);
}

template <typename T, int kGroup>
__global__ void __launch_bounds__(kResidentMaxThreads, 1)
jacobi_svd_resident_kernel(typename Complex2<T>::type* __restrict__ X,
                           typename Complex2<T>::type* __restrict__ W,
                           const int* __restrict__ sched, int* __restrict__ sweeps,
                           int n, int len, int max_sweeps, float threshold) {
  static_assert(kGroup < 32 && 32 % kGroup == 0, "a group is part of a warp");
  using C2 = typename Complex2<T>::type;
  extern __shared__ __align__(16) unsigned char shared[];
  C2* Xs = reinterpret_cast<C2*>(shared);                          // [n, len]
  C2* Ws = Xs + static_cast<size_t>(n) * len;                      // [n, n]
  Acc* norms = reinterpret_cast<Acc*>(Ws + static_cast<size_t>(n) * n);  // [n]
  Acc* red = norms + n;                                            // [32]
  const int tid = threadIdx.x;
  const int k = n / 2;
  const int g = tid / kGroup;      // the pair slot this group serves
  const int lane = tid % kGroup;
  const bool active = g < k;       // the last warp may hold an idle group
  const unsigned mask = ((1u << kGroup) - 1u) << ((tid & 31) & ~(kGroup - 1));

  // X in (16-byte words: n is even, so both matrices are whole words), W = I
  const int x_words = n * len * static_cast<int>(sizeof(C2)) / 16;
  const int w_words = n * n * static_cast<int>(sizeof(C2)) / 16;
  for (int i = tid; i < x_words; i += blockDim.x)
    reinterpret_cast<uint4*>(Xs)[i] = reinterpret_cast<const uint4*>(X)[i];
  for (int i = tid; i < n * n; i += blockDim.x) {
    C2 e;
    e.x = static_cast<T>(i / n == i % n ? 1 : 0);
    e.y = static_cast<T>(0);
    Ws[i] = e;
  }
  __syncthreads();

  int s = 0;
  while (s < max_sweeps) {
    // fresh column norms at sweep start: group g sums rows g and g + k
    if (active) {
      for (int r = g; r < n; r += k) {
        const Acc v = group_sum<kGroup>(
            row_norm2<T, kGroup>(Xs + static_cast<size_t>(r) * len, len, lane), mask);
        if (lane == 0) norms[r] = v;
      }
    }
    __syncthreads();
    Acc maxn2 = 0.0;
    for (int r = 0; r < n; ++r) maxn2 = fmax(maxn2, norms[r]);
    const Acc inv_maxn2_sq = 1.0 / fmax(maxn2 * maxn2, 1e-30);
    Acc run_max = 0.0;
    int l = active ? __ldg(sched + g) : 0;
    int r = active ? __ldg(sched + k + g) : 0;
    __syncthreads();  // every thread has read the norms before step 0 rewrites them

    for (int t = 0; t < n - 1; ++t) {
      int next_l = 0, next_r = 0;
      if (active && t + 2 < n) {   // the next step's slots, read during this one
        next_l = __ldg(sched + static_cast<size_t>(t + 1) * n + g);
        next_r = __ldg(sched + static_cast<size_t>(t + 1) * n + k + g);
      }
      if (active) {
        C2* u_row = Xs + static_cast<size_t>(l) * len;
        C2* v_row = Xs + static_cast<size_t>(r) * len;
        const Acc a = norms[l];
        const Acc b = norms[r];
        Acc c_re, c_im;
        row_overlap<T, kGroup>(u_row, v_row, len, lane, c_re, c_im);
        c_re = group_sum<kGroup>(c_re, mask);
        c_im = group_sum<kGroup>(c_im, mask);
        const Acc abs2c = c_re * c_re + c_im * c_im;
        run_max = fmax(run_max, abs2c * inv_maxn2_sq);

        const Rotation q = pair_rotation(a, b, c_re, c_im, abs2c);
        rotate_rows<T, kGroup>(u_row, v_row, len, lane, q.cs, q.w1_re, q.w1_im,
                               q.w2_re, q.w2_im);
        rotate_rows<T, kGroup>(Ws + static_cast<size_t>(l) * n,
                               Ws + static_cast<size_t>(r) * n, n, lane, q.cs,
                               q.w1_re, q.w1_im, q.w2_re, q.w2_im);
        __syncwarp(mask);  // every lane has read a, b before lane 0 overwrites them
        if (lane == 0) {
          norms[l] = a - q.t * q.absc;
          norms[r] = b + q.t * q.absc;
        }
      }
      __syncthreads();  // the next step pairs rows written by other groups
      l = next_l;
      r = next_r;
    }

    // the sweep's measure: max over the warps, decided by thread 0
    run_max = warp_max(run_max);
    if ((tid & 31) == 0) red[tid >> 5] = run_max;
    __syncthreads();
    if (tid == 0) {
      Acc m = 0.0;
      for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) m = fmax(m, red[w]);
      red[0] = m;
    }
    __syncthreads();
    ++s;
    if (static_cast<float>(red[0]) < threshold) break;
  }

  for (int i = tid; i < x_words; i += blockDim.x)
    reinterpret_cast<uint4*>(X)[i] = reinterpret_cast<const uint4*>(Xs)[i];
  for (int i = tid; i < w_words; i += blockDim.x)
    reinterpret_cast<uint4*>(W)[i] = reinterpret_cast<const uint4*>(Ws)[i];
  if (tid == 0) *sweeps = s;
}

template <typename T, int kGroup>
int launch_resident_group(void* X, void* W, const void* sched, void* sweeps,
                          int n, int len, int max_sweeps, float threshold,
                          void* stream) {
  using C2 = typename Complex2<T>::type;
  const int threads = (n / 2 * kGroup + 31) / 32 * 32;
  const size_t shmem = resident_shmem_bytes<T>(n, len);
  if (threads > kResidentMaxThreads) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      jacobi_svd_resident_kernel<T, kGroup>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(shmem));
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the next launch's check must not see it
    return static_cast<int>(err);
  }
  jacobi_svd_resident_kernel<T, kGroup>
      <<<1, threads, shmem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<C2*>(X), static_cast<C2*>(W), static_cast<const int*>(sched),
          static_cast<int*>(sweeps), n, len, max_sweeps, threshold);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_resident(void* X, void* W, const void* sched, void* sweeps, int n,
                    int len, int max_sweeps, float threshold, void* stream) {
  if (n < 4 || n % 2 || len < 1 || max_sweeps < 0 ||
      resident_shmem_bytes<T>(n, len) > static_cast<size_t>(kMaxSharedBytes))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 96)
    return launch_resident_group<T, 16>(X, W, sched, sweeps, n, len, max_sweeps,
                                        threshold, stream);
  return launch_resident_group<T, 8>(X, W, sched, sweeps, n, len, max_sweeps,
                                     threshold, stream);
}

}  // namespace

// C interface for ctypes: X complex [batch, n, len] is rotated in place,
// sched int32 [n-1, n], measure float64 [batch].  Enqueues one sweep on
// `stream` without synchronizing; returns cudaGetLastError().
extern "C" int tct_jacobi_sweep_c64(void* X, const void* sched, void* measure,
                                    int batch, int n, int len, void* stream) {
  return launch<float, false>(X, nullptr, sched, measure, batch, n, len, stream);
}

extern "C" int tct_jacobi_sweep_c128(void* X, const void* sched, void* measure,
                                     int batch, int n, int len, void* stream) {
  return launch<double, false>(X, nullptr, sched, measure, batch, n, len, stream);
}

// The V-accumulating sweep: as above, and W complex [batch, n, n] (rows =
// columns of V) is rotated in place with the same rotations.
extern "C" int tct_jacobi_sweep_v_c64(void* X, void* W, const void* sched,
                                      void* measure, int batch, int n, int len,
                                      void* stream) {
  return launch<float, true>(X, W, sched, measure, batch, n, len, stream);
}

extern "C" int tct_jacobi_sweep_v_c128(void* X, void* W, const void* sched,
                                       void* measure, int batch, int n, int len,
                                       void* stream) {
  return launch<double, true>(X, W, sched, measure, batch, n, len, stream);
}

// The resident sweep loop of one matrix: X complex [1, n, len] (16-byte
// aligned) is rotated in place, W complex [1, n, n] is written with the
// accumulated rotations from W = I, and the int32 *sweeps with the number of
// sweeps run (at most max_sweeps; the loop stops after the first sweep whose
// measure, rounded to float, is below threshold).  Enqueues one launch on
// `stream` without synchronizing; returns cudaFuncSetAttribute's error or
// cudaGetLastError(), cudaErrorInvalidValue for a shape it does not take.
extern "C" int tct_jacobi_svd_resident_c64(void* X, void* W, const void* sched,
                                           void* sweeps, int n, int len,
                                           int max_sweeps, float threshold,
                                           void* stream) {
  return launch_resident<float>(X, W, sched, sweeps, n, len, max_sweeps,
                                threshold, stream);
}

extern "C" int tct_jacobi_svd_resident_c128(void* X, void* W, const void* sched,
                                            void* sweeps, int n, int len,
                                            int max_sweeps, float threshold,
                                            void* stream) {
  return launch_resident<double>(X, W, sched, sweeps, n, len, max_sweeps,
                                 threshold, stream);
}
