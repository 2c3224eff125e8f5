// One tournament sweep of one-sided complex Jacobi, for Hopper (sm_90a).
//
// Two kernels from one template (kWithV):
//   * kWithV = false replaces
//     timecrystal_tpu/ops/pallas/jacobi_svd.py::_jacobi_sweep_kernel, the
//     V-free sweep that jacobi_sv runs on theta^H;
//   * kWithV = true replaces ::_jacobi_sweep_v_kernel, the same sweep that
//     also rotates the accumulator V (V0 = I) -- jacobi_svd's full
//     (U, S, Vh), run on theta itself.
// Both compute what the Pallas kernels compute:
//   * column norms recomputed fresh at sweep start, then carried through
//     the sweep incrementally (a' = a - t|c|, b' = b + t|c|);
//   * n-1 steps; each orthogonalizes all n/2 column pairs with the complex
//     Givens rotation of _pair_rotation (sign at tau = 0 taken POSITIVE,
//     |c| guarded at 1e-30); with kWithV the same rotation (cs, w1, w2) is
//     applied to the pair's two rows of V;
//   * the sweep's convergence measure max_pairs |c|^2 / maxn2^2, maxn2 the
//     sweep-start max column norm^2.
// The host wrapper (ops/jacobi_svd.py) takes the batch max of the measure
// and decides whether to launch another sweep, as the JAX while_loop does.
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
// Design and bound: one CTA per matrix, one launch per sweep.  Warps loop
// over the pairs of a step (a warp-reduced dot product for c, then the
// rotation of the two rows, and with kWithV of the two V rows), with
// __syncthreads() between steps.  Rows stay in device memory / L2 (an
// n = 512 complex64 matrix is 2 MiB, more than an SM's 227 KB of shared
// memory); only the norms and the running max live in shared memory.  Each
// step reads every row twice (the second read mostly from L1) and writes it
// once, so the kernel is bound by L2 / device-memory bytes per step and by
// the n-1 dependent steps.  The least time for the work is the larger of
// bytes / 3.35 TB/s (each matrix read and written once) and FLOPs / peak,
// with (n-1) (n/2) (28 len + 20 n [kWithV]) FLOPs per matrix and sweep: per
// element, 8 for the overlap and 2 x (2 + 6 + 2) for rotate_rows' two outputs.
// With one CTA per matrix a call of 20 matrices (the single-chain leg)
// keeps 20 of the 132 SMs busy, and TDVP's split (one [2 chi, 2 chi] matrix
// per call) keeps one: it is latency-bound by the 2 chi - 1 dependent steps.

#include <cuda_runtime.h>

namespace {

using Acc = double;

template <typename T> struct Complex2;
template <> struct Complex2<float> { using type = float2; };
template <> struct Complex2<double> { using type = double2; };

constexpr int kMaxWarps = 16;

__device__ __forceinline__ Acc warp_sum(Acc v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ Acc warp_max(Acc v) {
  for (int o = 16; o > 0; o >>= 1) v = fmax(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// u' = cs u - w1 v ; v' = w2 u + cs v over rows of length len, formed in
// Acc and stored as T; lanes stride the row.
template <typename T>
__device__ __forceinline__ void rotate_rows(typename Complex2<T>::type* u_row,
                                            typename Complex2<T>::type* v_row,
                                            int len, int lane, Acc cs, Acc w1_re,
                                            Acc w1_im, Acc w2_re, Acc w2_im) {
  using C2 = typename Complex2<T>::type;
  for (int i = lane; i < len; i += 32) {
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
    const C2* row = A + static_cast<size_t>(r) * len;
    Acc s = 0.0;
    for (int i = lane; i < len; i += 32) {
      const C2 v = row[i];
      s += static_cast<Acc>(v.x) * v.x + static_cast<Acc>(v.y) * v.y;
    }
    s = warp_sum(s);
    if (lane == 0) norms[r] = s;
  }
  __syncthreads();
  Acc maxn2 = 0.0;
  for (int r = 0; r < n; ++r) maxn2 = fmax(maxn2, norms[r]);
  const Acc inv_maxn2_sq = 1.0 / fmax(maxn2 * maxn2, 1e-30);
  Acc run_max = 0.0;

  for (int t = 0; t < n - 1; ++t) {
    const int* slot = sched + static_cast<size_t>(t) * n;
    for (int p = warp; p < k; p += nwarps) {
      const int l = slot[p];
      const int r = slot[k + p];
      C2* u_row = A + static_cast<size_t>(l) * len;
      C2* v_row = A + static_cast<size_t>(r) * len;
      const Acc a = norms[l];
      const Acc b = norms[r];
      Acc c_re = 0.0, c_im = 0.0;  // c = <L, R> = sum conj(u) v
      for (int i = lane; i < len; i += 32) {
        const C2 u = u_row[i], v = v_row[i];
        c_re += static_cast<Acc>(u.x) * v.x + static_cast<Acc>(u.y) * v.y;
        c_im += static_cast<Acc>(u.x) * v.y - static_cast<Acc>(u.y) * v.x;
      }
      c_re = warp_sum(c_re);
      c_im = warp_sum(c_im);
      const Acc abs2c = c_re * c_re + c_im * c_im;
      run_max = fmax(run_max, abs2c * inv_maxn2_sq);

      // _pair_rotation (jacobi_svd.py:46)
      const Acc absc = sqrt(abs2c);
      const bool safe = absc > 1e-30;
      const Acc tau = safe ? (b - a) / fmax(2.0 * absc, 1e-30) : 0.0;
      const Acc sgn = tau >= 0.0 ? 1.0 : -1.0;
      Acc t_ = sgn / (fabs(tau) + sqrt(1.0 + tau * tau));
      t_ = safe ? t_ : 0.0;
      const Acc cs = 1.0 / sqrt(1.0 + t_ * t_);
      const Acc sn = cs * t_;
      const Acc ph_re = safe ? c_re / fmax(absc, 1e-30) : 1.0;
      const Acc ph_im = safe ? c_im / fmax(absc, 1e-30) : 0.0;
      const Acc w1_re = sn * ph_re, w1_im = -sn * ph_im;  // w1 = sn conj(ph)
      const Acc w2_re = sn * ph_re, w2_im = sn * ph_im;   // w2 = sn ph

      rotate_rows<T>(u_row, v_row, len, lane, cs, w1_re, w1_im, w2_re, w2_im);
      if constexpr (kWithV) {
        rotate_rows<T>(Vb + static_cast<size_t>(l) * n,
                       Vb + static_cast<size_t>(r) * n, n, lane, cs, w1_re,
                       w1_im, w2_re, w2_im);
      }
      __syncwarp();  // every lane has read a, b before lane 0 overwrites them
      if (lane == 0) {
        norms[l] = a - t_ * absc;
        norms[r] = b + t_ * absc;
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
