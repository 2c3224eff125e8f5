// One-sided complex Jacobi for Hopper (sm_90a): the tournament sweep of
// timecrystal_tpu/ops/pallas/jacobi_svd.py's two Pallas kernels.
//
// Kernel 1, ::_jacobi_sweep_kernel (:159), the V-free sweep that jacobi_sv
// runs on theta^H, in two variants picked by shape (ops/jacobi_svd.py):
//   * jacobi_sv_smem_kernel<T>: one CTA per matrix,
//     the matrix resident in shared memory for the whole sweep (every
//     window matrix: complex64 up to n = 168, complex128 up to n = 120);
//   * jacobi_sv_cluster_kernel<T>: a thread-block cluster of up to 8 CTAs
//     per matrix, rows in device memory / L2 (the n = 512 leg).
// Both run one sweep per launch and test the caller's exit rule themselves
// (sweep_is_skipped): the host enqueues max_sweeps launches and reads
// nothing, as the JAX while_loop never leaves the device.
//
// Kernel 2, ::_jacobi_sweep_v_kernel (:75), the same sweep that also
// rotates the accumulator V (V0 = I) -- jacobi_svd's full (U, S, Vh):
//   * jacobi_sweep_v_kernel<T>: one CTA per matrix, one launch per sweep,
//     the host reading the batch-max measure after each;
//   * jacobi_svd_resident_kernel<T, kGroup>: one launch runs every sweep of
//     one matrix held in shared memory and tests the exit rule itself.
//
// Every kernel computes what the Pallas kernels compute:
//   * column norms recomputed fresh at sweep start, then carried through
//     the sweep incrementally (a' = a - t|c|, b' = b + t|c|);
//   * n-1 steps; each orthogonalizes all n/2 column pairs with the complex
//     Givens rotation of _pair_rotation (sign at tau = 0 taken POSITIVE,
//     |c| guarded at 1e-30); with V the same rotation (cs, w1, w2) is
//     applied to the pair's two rows of V;
//   * the sweep's convergence measure max_pairs |c|^2 / maxn2^2, maxn2 the
//     sweep-start max column norm^2;
//   * the loop stops after the first sweep whose batch-max measure, rounded
//     to float, is below threshold (the float32 tol^2 the host passes: the
//     host loop's rule, bit for bit), or after max_sweeps.
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
// The device exit (kernel 1).  At batch 320 the CTAs of one launch are not
// all resident at once, so no CTA can wait for the others' measures inside
// a launch.  Instead launch s >= 1 starts by reading a device flag `done`
// and the B measures launch s-1 wrote: if the flag is set, or the batch max
// (rounded to float) is below threshold, it sets the flag and returns
// without touching X, so the launches after the exit cost a few
// microseconds each.  Every CTA reads the same values and takes the same
// decision.  A launch that runs its sweep adds one to a device counter of
// sweeps (block 0 only).
//
// Kernel 1, shared-memory variant.  The per-sweep kernel before it read
// every row from L2 twice and wrote it once in each of the n-1 dependent
// steps, and serialized a step's pairs inside each warp.  Here the CTA
// loads X into dynamic shared memory with 16-byte loads at launch start
// and writes it back at the end (n (len itemsize) + (n + 32) 8 bytes must
// fit the 232448 one block can use; cudaFuncSetAttribute above 48 KB), and
// every pair of a step has its own group of kSmemGroup = 8 lanes, so a step
// is one round ended by one __syncthreads().  8 lanes keep the CTA small:
// 256 threads at n = 64, so that three CTAs (33 KB of shared memory each)
// share an SM and the whole [320, 64, 64] batch is resident at once; 16
// lanes would need 512 threads a CTA and ~40 registers a thread for that,
// and 4 lanes (twice the CTAs an SM) were slower at every window shape.
// One launch bound, sized for the largest CTA (n = 168, 672 threads), leaves
// the register count low enough for 3 CTAs an SM at n = 64 and 2 at n = 96.
// At n = 144 (166 KB) one CTA fits an SM: 320 matrices take three waves on
// 132 SMs.  A group sums a row with a lane stride of 8, so its overlaps and
// norms round differently from the cluster variant's (stride 32, as the
// kernel both replace): the variants agree to rounding, not bit for bit.
// The rotation parameters are computed redundantly by every lane of a
// group: a warp issues the dependent double chain (~6 divisions and square
// roots) once for its 4 pairs, and computing them in one lane of the group
// and broadcasting them by shuffle was no faster.  On a dense matrix its
// floor is FP64 work: 28 len FLOPs per pair and step plus 12 float <-> double
// conversions per element for complex64 (4 for the overlap, 8 for the
// rotation), at a quarter of the FP64 FMA rate.
//
// The padded MPS is mostly exact zeros: the drive diagram pads chi to 48
// and caps it at 24, and apply_bond_gates zeros every discarded Schmidt
// value and its rows of Vh, so a [96, 96] theta has at most 48 live rows
// and 6 of its 12 8-column chunks live.  The variant skips that work, and
// skipping it is exact.  The sweep-start pass that sums the norms also marks
// which rows and which chunks hold a nonzero element (bit masks in the
// reduction scratch).  A pair with a zero row has c = 0 exactly, so its
// rotation is t = 0, cs = 1, w = 0: the identity, norms unchanged, measure
// 0; and a rotation mixes only element j of its two rows, so a zero row and
// a chunk zero in every row stay zero for the whole sweep.  So, per sweep:
//   * the CTA lists the pairs of every step whose two rows are live,
//     compacted onto groups 0 .. P_t - 1 by ballots, in the scratch `pairs`
//     the wrapper allocates (uint16 l | r << 8, [B, n-1, n/2], 8.8 MB at
//     [960, 96, 96], in L2), and each group reads its entry a step ahead:
//     groups past P_t wait at the step's barrier, warps past P_t / 4 run
//     nothing;
//   * in rows of up to 32 chunks (len <= 256: every square matrix the
//     variant takes) the live chunks are moved, in order, to the front of
//     each row and the dense loops run over those columns alone.  Chunk j
//     is lane l's element 8 j + l either way, so each lane still sums and
//     rotates its own elements in the dense sweep's order, less terms that
//     are +-0; the live columns go back to their places at the end, the
//     zeros are not rewritten.  (Looping over a chunk mask instead kept the
//     compiler from unrolling the loops: 24-35% slower on dense input on an
//     H100.)
// So X, the norms, the measure and the sweep count are the dense sweep's
// bit for bit, but for the sign of a zero that is no longer rewritten (for
// finite input).  A dense matrix (every row and chunk live) reads the
// schedule and runs the dense sweep's step loop (sweep_steps<T, true>) and
// builds no list: the list and a pair flag read from it each step made
// dense input 1.3-5.2% slower at [320, 64/96, 64/96] and [960, 64, 64] on
// an H100.
// Dense input pays the marking alone.  What bounds the sparse sweep is
// each step's latency: the dependent FP64 chain of the rotation parameters
// and the barrier, for n-1 steps, of which a tournament over the live rows
// alone would need fewer (another rotation order).  Block 0 adds the
// scheduled pair-steps B (n-1) n/2, and each CTA its live pair-steps, to
// the device counter pair_steps [2].
//
// Kernel 1, cluster variant.  A complex64 n = 512 matrix is 2 MiB, more than
// an SM holds, and one CTA per matrix kept 20 of 132 SMs busy on the n = 512
// leg.  Here a cluster of C <= 8 CTAs (the portable size) shares a matrix:
// warp w of CTA rank r takes pairs p = 16 r + w, p + 16 C, ...; in each step
// the warp reads its pair's two rows for the overlap, reads them again for
// the rotation and writes them, the rows staying in device memory / L2.
// Loads and stores go through L2 only (ld.global.cg / st.global.cg), so a
// row written by another SM in the last step is never read from a stale L1
// line.  Consecutive steps are separated by the cluster barrier
// (barrier.cluster.arrive.release / wait.acquire), which orders the row
// writes inside the cluster.  Every CTA keeps a copy of the matrix's carried
// norms in shared memory; the warp that rotates a pair writes the two new
// norms into every CTA of the cluster over distributed shared memory (lane j
// to rank j), and the sweep's measure is gathered in rank 0 the same way.  A
// CTA is 512 threads (16 warps) held to 64 registers, two CTAs an SM.
// Holding the pair's two rows in registers instead (one read and one write
// a step, 127 registers, one CTA an SM) was slower at every shape timed:
// the second CTA an SM hides each pair's dependent chain (shuffle reduction,
// rotation parameters) better than the saved L2 pass does.  The host picks C
// as the largest size (8 down to 1) for which cudaOccupancyMaxActiveClusters
// keeps the whole batch resident at once (tct_jacobi_sweep_cluster_plan_*):
// a second wave would double the sweep.  The floor is the L2 traffic: 511
// steps x 6 MiB x 20 matrices ~ 64 GB per sweep at [20, 512, 512].
//
// Kernel 2, per-sweep (jacobi_sweep_v_kernel): one CTA per matrix, warps
// loop over the pairs of a step (a warp-reduced dot product for c, then the
// rotation of the two X rows and the two V rows), __syncthreads() between
// steps, rows in device memory / L2.  It serves every jacobi_svd call the
// resident kernel does not take (batches, matrices too large for one SM).
//
// Kernel 2, resident (jacobi_svd_resident_kernel): TDVP's split is one
// [2 chi, 2 chi] matrix per call.  The kernel loads X once into dynamic
// shared memory and builds W = I there, keeps both for every sweep and
// writes them back once; every pair of a step has its own group of kGroup
// lanes (16 up to n = 96, 768 threads; 8 above, so that n up to 192 stays
// within 768 threads and __launch_bounds__ leaves 80 registers a thread);
// the next step's two indices are loaded during the current step; the
// sweep's measure is reduced over the warps in shared memory and thread 0
// decides, so the loop and its exit run on the device.  It takes a call
// when B == 1 and n (len + n) itemsize + (n + 32) 8 bytes fit in the 232448
// bytes of shared memory one block can use: complex64 up to n = 120,
// complex128 up to n = 84.  Its floor is the work of one SM: FLOPs over the
// per-SM FP64 rate (34 TFLOP/s / 132), 21.0 MFLOP per sweep at [1, 96, 96],
// ~82 us.  No tensor cores anywhere: a pair rotation is a 2 x 2 transform of
// two rows, not a matrix product (blocked Jacobi with GEMM-applied rotations
// is another algorithm, with another rotation order).
//
// A launch that asks for more shared memory than the attribute allows, or
// for a cluster the card cannot place, is refused and never runs: every C
// entry returns the launch's error (cudaGetLastError() or the launch API's)
// and the wrapper raises on it.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

namespace cg = cooperative_groups;

using Acc = double;

template <typename T> struct Complex2;
template <> struct Complex2<float> { using type = float2; };
template <> struct Complex2<double> { using type = double2; };

constexpr int kMaxWarps = 16;
constexpr int kResidentMaxThreads = 768;
constexpr int kMaxSharedBytes = 232448;   // one block's shared memory, sm_90
constexpr int kSmemGroup = 8;             // lanes per pair, shared-memory variant
constexpr int kSmemMaxThreads = 672;      // its largest CTA: n = 168, 84 pairs
constexpr int kClusterThreads = 512;      // 16 warps, one pair per warp at a time
constexpr int kClusterWarps = kClusterThreads / 32;
constexpr int kMaxCluster = 8;            // the portable cluster size

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

// c += conj(u) v for one element
template <typename C2>
__device__ __forceinline__ void overlap_add(const C2& u, const C2& v, Acc& c_re,
                                            Acc& c_im) {
  c_re += static_cast<Acc>(u.x) * v.x + static_cast<Acc>(u.y) * v.y;
  c_im += static_cast<Acc>(u.x) * v.y - static_cast<Acc>(u.y) * v.x;
}

// this lane's share of c = <u, v> = sum conj(u) v
template <typename T, int kStride>
__device__ __forceinline__ void row_overlap(const typename Complex2<T>::type* u_row,
                                            const typename Complex2<T>::type* v_row,
                                            int len, int lane, Acc& c_re, Acc& c_im) {
  c_re = 0.0;
  c_im = 0.0;
  for (int i = lane; i < len; i += kStride) overlap_add(u_row[i], v_row[i], c_re, c_im);
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

// u' = cs u - w1 v ; v' = w2 u + cs v for one element, formed in Acc and
// stored as T
template <typename T>
__device__ __forceinline__ void rotate_elem(typename Complex2<T>::type& u,
                                            typename Complex2<T>::type& v,
                                            const Rotation& q) {
  const Acc ux = u.x, uy = u.y, vx = v.x, vy = v.y;
  u.x = static_cast<T>(q.cs * ux - (q.w1_re * vx - q.w1_im * vy));
  u.y = static_cast<T>(q.cs * uy - (q.w1_re * vy + q.w1_im * vx));
  v.x = static_cast<T>((q.w2_re * ux - q.w2_im * uy) + q.cs * vx);
  v.y = static_cast<T>((q.w2_re * uy + q.w2_im * ux) + q.cs * vy);
}

// rotate_elem over rows of length len; lanes stride the row by kStride
template <typename T, int kStride = 32>
__device__ __forceinline__ void rotate_rows(typename Complex2<T>::type* u_row,
                                            typename Complex2<T>::type* v_row,
                                            int len, int lane, const Rotation& q) {
  for (int i = lane; i < len; i += kStride) {
    typename Complex2<T>::type u = u_row[i], v = v_row[i];
    rotate_elem<T>(u, v, q);
    u_row[i] = u;
    v_row[i] = v;
  }
}

// ---------------------------------------------------------------- kernel 1

// The exit test at a launch's start (every thread of the block calls it;
// the result is the same in every CTA of the launch): prev == nullptr for
// the first sweep of a loop and for a lone sweep.  red is [32] of block
// scratch, free again on return.
__device__ __forceinline__ bool sweep_is_skipped(const Acc* __restrict__ prev,
                                                 int* done, int batch,
                                                 float threshold, Acc* red) {
  if (prev == nullptr) return false;
  const int tid = threadIdx.x;
  Acc m = 0.0;
  for (int i = tid; i < batch; i += blockDim.x) m = fmax(m, prev[i]);
  m = warp_max(m);
  if ((tid & 31) == 0) red[tid >> 5] = m;
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < static_cast<int>(blockDim.x >> 5); ++w) m = fmax(m, red[w]);
    const bool skip =
        *static_cast<volatile int*>(done) != 0 || static_cast<float>(m) < threshold;
    if (skip) *done = 1;
    red[0] = skip ? 1.0 : 0.0;
  }
  __syncthreads();
  const bool skip = red[0] != 0.0;
  __syncthreads();  // red is free for the caller
  return skip;
}

__device__ __forceinline__ void count_sweep(unsigned long long* sweeps) {
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(sweeps, 1ull);
}

// Shared memory of the shared-memory variant: X [n, len] in T, the norms [n]
// and the reduction scratch [32] in Acc.
template <typename T>
size_t smem_bytes(int n, int len) {
  using C2 = typename Complex2<T>::type;
  return static_cast<size_t>(n) * len * sizeof(C2) +
         static_cast<size_t>(n + 32) * sizeof(Acc);
}

// While the shared-memory variant sweeps, its reduction scratch holds which
// rows are live (a bit mask), which 8-column chunks are (one word: chunks
// are skipped in rows of up to 32 of them, len <= kChunkColumns) and the
// count of live pairs; a group's list entry is l | r << 8, or kNoPair.
constexpr int kRowWords = 8;                      // rows < 256
constexpr int kChunkColumns = 32 * kSmemGroup;    // the columns the chunk mask covers
constexpr int kNoPair = 0xffff;
static_assert(kSmemMaxThreads / kSmemGroup * 2 < 255, "rows fit a byte of the entry");

// the pair (l, r) group g takes at step t, and whether it has one: the
// schedule's slot g (kDense) or entry g of the CTA's list of live pairs
template <bool kDense>
__device__ __forceinline__ bool step_pair(const int* __restrict__ sched,
                                          const unsigned short* list, int t, int n,
                                          int g, int& l, int& r) {
  const int k = n / 2;
  if (kDense) {
    l = __ldg(sched + static_cast<size_t>(t) * n + g);
    r = __ldg(sched + static_cast<size_t>(t) * n + k + g);
    return true;
  }
  const int e = list[static_cast<size_t>(t) * k + g];
  l = e & 0xff;
  r = e >> 8;
  return e != kNoPair;
}

// The n-1 steps of the shared-memory variant over the first `cols` columns
// of the rows in Xs (row stride len), group g taking the pair step_pair
// names; returns this thread's max of |c|^2 / maxn2^2.  On a dense matrix
// (kDense: every row live, cols = len) a group has a pair at every step and
// the loop is the dense sweep's.
template <typename T, bool kDense>
__device__ __forceinline__ Acc sweep_steps(typename Complex2<T>::type* Xs, Acc* norms,
                                           const int* __restrict__ sched,
                                           const unsigned short* list, int n, int len,
                                           int cols, int g, int lane, unsigned mask,
                                           bool active, Acc inv_maxn2_sq) {
  using C2 = typename Complex2<T>::type;
  Acc run_max = 0.0;
  int l = 0, r = 0;
  bool on = active && step_pair<kDense>(sched, list, 0, n, g, l, r);
  __syncthreads();  // every thread has read the norms before step 0 rewrites them

  for (int t = 0; t < n - 1; ++t) {
    int next_l = 0, next_r = 0;  // the next step's pair, read during this one
    const bool next_on =
        active && t + 2 < n && step_pair<kDense>(sched, list, t + 1, n, g, next_l, next_r);
    if (on) {
      C2* u_row = Xs + static_cast<size_t>(l) * len;
      C2* v_row = Xs + static_cast<size_t>(r) * len;
      const Acc a = norms[l];
      const Acc b = norms[r];
      Acc c_re, c_im;
      row_overlap<T, kSmemGroup>(u_row, v_row, cols, lane, c_re, c_im);
      c_re = group_sum<kSmemGroup>(c_re, mask);
      c_im = group_sum<kSmemGroup>(c_im, mask);
      const Acc abs2c = c_re * c_re + c_im * c_im;
      run_max = fmax(run_max, abs2c * inv_maxn2_sq);

      const Rotation q = pair_rotation(a, b, c_re, c_im, abs2c);
      rotate_rows<T, kSmemGroup>(u_row, v_row, cols, lane, q);
      __syncwarp(mask);  // every lane has read a, b before lane 0 overwrites them
      if (lane == 0) {
        norms[l] = a - q.t * q.absc;
        norms[r] = b + q.t * q.absc;
      }
    }
    __syncthreads();  // the next step pairs rows written by other groups
    l = next_l;
    r = next_r;
    on = next_on;
  }
  return run_max;
}

// where column col of a row sits once the live chunks (bit c of live: chunk
// c, columns 8 c .. 8 c + 7) are moved, in order, to the front of the row
__device__ __forceinline__ int live_column(unsigned live, int col) {
  const int c = col / kSmemGroup;
  return kSmemGroup * __popc(live & ((1u << c) - 1u)) + col % kSmemGroup;
}

template <typename T>
__global__ void __launch_bounds__(kSmemMaxThreads, 1)
jacobi_sv_smem_kernel(typename Complex2<T>::type* __restrict__ X,
                      const int* __restrict__ sched, const Acc* __restrict__ prev,
                      Acc* __restrict__ measure, int* done,
                      unsigned long long* sweeps, unsigned short* pairs,
                      unsigned long long* pair_steps, int batch, int n, int len,
                      float threshold) {
  using C2 = typename Complex2<T>::type;
  extern __shared__ __align__(16) unsigned char shared[];
  C2* Xs = reinterpret_cast<C2*>(shared);                                // [n, len]
  Acc* norms = reinterpret_cast<Acc*>(Xs + static_cast<size_t>(n) * len);  // [n]
  Acc* red = norms + n;                                                  // [32]
  if (sweep_is_skipped(prev, done, batch, threshold, red)) return;
  count_sweep(sweeps);

  const int tid = threadIdx.x;
  const int k = n / 2;
  const int g = tid / kSmemGroup;  // the pair slot this group serves
  const int lane = tid % kSmemGroup;
  const bool active = g < k;       // the last warp may hold idle groups
  const unsigned mask = ((1u << kSmemGroup) - 1u) << ((tid & 31) & ~(kSmemGroup - 1));
  C2* A = X + static_cast<size_t>(blockIdx.x) * n * len;
  unsigned* live_rows = reinterpret_cast<unsigned*>(red);   // [kRowWords]
  unsigned* live_pairs = live_rows + kRowWords;             // [1]
  unsigned* live_chunks = live_rows + kRowWords + 1;        // [1]
  unsigned short* list = pairs + static_cast<size_t>(blockIdx.x) * (n - 1) * k;

  // X in, as 16-byte words (n is even, so the matrix is whole words)
  const int words = n * len * static_cast<int>(sizeof(C2)) / 16;
  for (int i = tid; i < words; i += blockDim.x)
    reinterpret_cast<uint4*>(Xs)[i] = reinterpret_cast<const uint4*>(A)[i];
  if (tid < kRowWords + 2) live_rows[tid] = 0u;
  __syncthreads();

  // fresh column norms at sweep start (group g sums rows g and g + k), and
  // which rows and chunks hold a nonzero element (bit j of a lane's word:
  // its element 8 j + lane; past 32 chunks the bits wrap, and only whether
  // the row is live is read)
  if (active) {
    for (int r = g; r < n; r += k) {
      const C2* row = Xs + static_cast<size_t>(r) * len;
      Acc s = 0.0;
      unsigned word = 0u;
      for (int i = lane, j = 0; i < len; i += kSmemGroup, ++j) {
        const C2 v = row[i];
        s += static_cast<Acc>(v.x) * v.x + static_cast<Acc>(v.y) * v.y;
        if (v.x != 0 || v.y != 0) word |= 1u << (j & 31);
      }
      s = group_sum<kSmemGroup>(s, mask);
      word = __reduce_or_sync(mask, word);
      if (lane == 0) {
        norms[r] = s;
        if (word != 0u) {
          atomicOr(live_rows + (r >> 5), 1u << (r & 31));
          atomicOr(live_chunks, word);
        }
      }
    }
  }
  __syncthreads();

  // the live chunks move, in order, to the front of every row, so that each
  // lane keeps its elements in their order and the sweep's loops run over
  // the first len_live columns; from the copy in device memory, as the
  // rows are still whole there
  int rows = 0;
  for (int w = 0; w < kRowWords; ++w) rows += __popc(live_rows[w]);
  const int chunks = (len + kSmemGroup - 1) / kSmemGroup;
  const unsigned live = *live_chunks;
  const bool compact =
      len <= kChunkColumns && live != (chunks == 32 ? ~0u : (1u << chunks) - 1u);
  const bool dense = rows == n && !compact;
  int len_live = len;
  if (compact) {
    const int tail = len % kSmemGroup;  // the last chunk's width, if partial
    len_live = kSmemGroup * __popc(live) -
               (tail != 0 && ((live >> (chunks - 1)) & 1u) ? kSmemGroup - tail : 0);
    for (int i = tid; i < n * len; i += blockDim.x) {
      const int col = i % len;
      if ((live >> (col / kSmemGroup)) & 1u) Xs[i - col + live_column(live, col)] = A[i];
    }
  }

  // unless the matrix is dense, the live pairs of every step, compacted:
  // entry p < P_t of step t is the p-th pair of the step whose two rows are
  // live, entries P_t .. k-1 are kNoPair; warp w builds steps w, w + warps
  if (!dense) {
    const int wl = tid & 31;
    unsigned found = 0u;
    for (int t = tid >> 5; t < n - 1; t += blockDim.x >> 5) {
      const int* slot = sched + static_cast<size_t>(t) * n;
      unsigned short* entry = list + static_cast<size_t>(t) * k;
      int base = 0;
      for (int p0 = 0; p0 < k; p0 += 32) {
        const int p = p0 + wl;
        const int l = p < k ? __ldg(slot + p) : 0;
        const int r = p < k ? __ldg(slot + k + p) : 0;
        const bool both = p < k && ((live_rows[l >> 5] >> (l & 31)) & 1u) &&
                          ((live_rows[r >> 5] >> (r & 31)) & 1u);
        const unsigned b = __ballot_sync(0xffffffffu, both);
        if (both)
          entry[base + __popc(b & ((1u << wl) - 1u))] = static_cast<unsigned short>(l | r << 8);
        base += __popc(b);
      }
      for (int p = base + wl; p < k; p += 32) entry[p] = kNoPair;
      found += base;
    }
    if (wl == 0 && found != 0u) atomicAdd(live_pairs, found);
  }
  __syncthreads();
  if (tid == 0) {
    atomicAdd(pair_steps, dense ? static_cast<unsigned long long>(n - 1) * k
                                : static_cast<unsigned long long>(*live_pairs));
    if (blockIdx.x == 0)
      atomicAdd(pair_steps + 1, static_cast<unsigned long long>(batch) * (n - 1) * k);
  }
  Acc maxn2 = 0.0;
  for (int r = 0; r < n; ++r) maxn2 = fmax(maxn2, norms[r]);
  const Acc inv_maxn2_sq = 1.0 / fmax(maxn2 * maxn2, 1e-30);
  // (the dense loop bound is the argument len: a copy in a register made
  // dense input up to 1.3% slower on an H100)
  Acc run_max =
      dense ? sweep_steps<T, true>(Xs, norms, sched, list, n, len, len, g, lane, mask,
                                   active, inv_maxn2_sq)
            : sweep_steps<T, false>(Xs, norms, sched, list, n, len, len_live, g, lane, mask,
                                    active, inv_maxn2_sq);

  // the sweep's measure: max over the warps
  run_max = warp_max(run_max);
  if ((tid & 31) == 0) red[tid >> 5] = run_max;
  __syncthreads();
  if (tid == 0) {
    Acc m = 0.0;
    for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) m = fmax(m, red[w]);
    measure[blockIdx.x] = m;
  }
  if (compact) {  // the live chunks back to their columns; the zeros stay
    for (int i = tid; i < n * len; i += blockDim.x) {
      const int col = i % len;
      if ((live >> (col / kSmemGroup)) & 1u) A[i] = Xs[i - col + live_column(live, col)];
    }
  } else {
    for (int i = tid; i < words; i += blockDim.x)
      reinterpret_cast<uint4*>(A)[i] = reinterpret_cast<const uint4*>(Xs)[i];
  }
}

inline int smem_threads(int n) { return (n / 2 * kSmemGroup + 31) / 32 * 32; }

template <typename T>
bool smem_takes(int batch, int n, int len) {
  return batch >= 1 && n >= 4 && n % 2 == 0 && len >= 1 &&
         smem_threads(n) <= kSmemMaxThreads &&
         smem_bytes<T>(n, len) <= static_cast<size_t>(kMaxSharedBytes);
}

template <typename T>
int launch_smem(void* X, const void* sched, const void* prev, void* measure,
                void* done, void* sweeps, void* pairs, void* pair_steps, int batch,
                int n, int len, float threshold, void* stream) {
  using C2 = typename Complex2<T>::type;
  if (!smem_takes<T>(batch, n, len)) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = smem_threads(n);
  const size_t shmem = smem_bytes<T>(n, len);
  const cudaError_t err =
      cudaFuncSetAttribute(jacobi_sv_smem_kernel<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(shmem));
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the next launch's check must not see it
    return static_cast<int>(err);
  }
  jacobi_sv_smem_kernel<T><<<batch, threads, shmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<C2*>(X), static_cast<const int*>(sched),
      static_cast<const Acc*>(prev), static_cast<Acc*>(measure),
      static_cast<int*>(done), static_cast<unsigned long long*>(sweeps),
      static_cast<unsigned short*>(pairs), static_cast<unsigned long long*>(pair_steps),
      batch, n, len, threshold);
  return static_cast<int>(cudaGetLastError());
}

// CTAs of the shared-memory variant that one SM holds at once for [n, len]
template <typename T>
int smem_occupancy(int n, int len, int* blocks) {
  if (!smem_takes<T>(1, n, len)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t shmem = smem_bytes<T>(n, len);
  cudaError_t err = cudaFuncSetAttribute(jacobi_sv_smem_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(shmem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, jacobi_sv_smem_kernel<T>,
                                                        smem_threads(n), shmem);
  if (err != cudaSuccess) cudaGetLastError();
  return static_cast<int>(err);
}

// Shared memory of the cluster variant: the norms [n], the block's
// reduction scratch [32] and rank 0's gather of the cluster's measures
// [kMaxCluster], all Acc.
inline size_t cluster_shmem_bytes(int n) {
  return static_cast<size_t>(n + 32 + kMaxCluster) * sizeof(Acc);
}

template <typename T>
__global__ void __launch_bounds__(kClusterThreads, 2)
jacobi_sv_cluster_kernel(typename Complex2<T>::type* __restrict__ X,
                         const int* __restrict__ sched, const Acc* __restrict__ prev,
                         Acc* __restrict__ measure, int* done,
                         unsigned long long* sweeps, int batch, int n, int len,
                         float threshold) {
  using C2 = typename Complex2<T>::type;
  extern __shared__ Acc smem[];
  Acc* norms = smem;               // [n], this CTA's copy
  Acc* red = smem + n;             // [32]
  Acc* gathered = red + 32;        // [kMaxCluster], read in rank 0
  if (sweep_is_skipped(prev, done, batch, threshold, red)) return;
  count_sweep(sweeps);

  cg::cluster_group cluster = cg::this_cluster();
  const int csize = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int first = rank * kClusterWarps + warp;   // this warp's first pair / row
  const int stride = csize * kClusterWarps;        // warps in the cluster
  const int k = n / 2;
  C2* A = X + static_cast<size_t>(blockIdx.x / csize) * n * len;
  // every CTA of the cluster has started before any writes into another's
  // shared memory (the exit test above decides alike in every CTA)
  cluster.sync();

  // fresh column norms at sweep start: one warp of the cluster sums a row
  // and sends it to every CTA's copy
  for (int r = first; r < n; r += stride) {
    const Acc s = group_sum(row_norm2<T, 32>(A + static_cast<size_t>(r) * len, len, lane));
    if (lane < csize) *cluster.map_shared_rank(norms + r, lane) = s;
  }
  cluster.sync();
  Acc maxn2 = 0.0;
  for (int r = 0; r < n; ++r) maxn2 = fmax(maxn2, norms[r]);
  const Acc inv_maxn2_sq = 1.0 / fmax(maxn2 * maxn2, 1e-30);
  Acc run_max = 0.0;
  cluster.sync();  // every CTA has read its norms before step 0 rewrites them

  for (int t = 0; t < n - 1; ++t) {
    const int* slot = sched + static_cast<size_t>(t) * n;
    for (int p = first; p < k; p += stride) {
      const int l = __ldg(slot + p);
      const int r = __ldg(slot + k + p);
      C2* u_row = A + static_cast<size_t>(l) * len;
      C2* v_row = A + static_cast<size_t>(r) * len;
      const Acc a = norms[l];
      const Acc b = norms[r];
      // one pass through L2 for the overlap, one for the rotation
      Acc c_re = 0.0, c_im = 0.0;
      for (int i = lane; i < len; i += 32)
        overlap_add(__ldcg(u_row + i), __ldcg(v_row + i), c_re, c_im);
      c_re = group_sum(c_re);
      c_im = group_sum(c_im);
      const Acc abs2c = c_re * c_re + c_im * c_im;
      run_max = fmax(run_max, abs2c * inv_maxn2_sq);
      const Rotation q = pair_rotation(a, b, c_re, c_im, abs2c);
      for (int i = lane; i < len; i += 32) {
        C2 u = __ldcg(u_row + i), v = __ldcg(v_row + i);
        rotate_elem<T>(u, v, q);
        __stcg(u_row + i, u);
        __stcg(v_row + i, v);
      }
      __syncwarp();  // every lane has read a, b before the norms are rewritten
      if (lane < csize) {
        Acc* dst = cluster.map_shared_rank(norms, lane);
        dst[l] = a - q.t * q.absc;
        dst[r] = b + q.t * q.absc;
      }
    }
    cluster.sync();  // rows and norms of this step are visible to the next
  }

  // the sweep's measure: max over the block's warps, then over the cluster
  // in rank 0
  run_max = warp_max(run_max);
  if (lane == 0) red[warp] = run_max;
  __syncthreads();
  if (threadIdx.x == 0) {
    Acc m = 0.0;
    for (int w = 0; w < kClusterWarps; ++w) m = fmax(m, red[w]);
    *cluster.map_shared_rank(gathered + rank, 0) = m;
  }
  cluster.sync();
  if (rank == 0 && threadIdx.x == 0) {
    Acc m = 0.0;
    for (int c = 0; c < csize; ++c) m = fmax(m, gathered[c]);
    measure[blockIdx.x / csize] = m;
  }
}

inline cudaLaunchConfig_t cluster_config(int batch, int n, int csize,
                                         cudaLaunchAttribute* attr, void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(batch * csize));
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = cluster_shmem_bytes(n);
  cfg.stream = static_cast<cudaStream_t>(stream);
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(csize);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The largest cluster size c <= kMaxCluster for which the card keeps all
// `batch` clusters resident at once (cudaOccupancyMaxActiveClusters), else
// 1; *active gets that size's count of co-resident clusters.
template <typename T>
int cluster_plan(int batch, int n, int len, int* csize, int* active) {
  if (batch < 1 || n < 4 || n % 2 || len < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int c = kMaxCluster; c >= 1; --c) {
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = cluster_config(batch, n, c, attr, nullptr);
    int count = 0;
    const cudaError_t err =
        cudaOccupancyMaxActiveClusters(&count, jacobi_sv_cluster_kernel<T>, &cfg);
    if (err != cudaSuccess) {
      cudaGetLastError();
      return static_cast<int>(err);
    }
    if (count >= batch || c == 1) {
      *csize = c;
      *active = count;
      return 0;
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch_cluster(void* X, const void* sched, const void* prev, void* measure,
                   void* done, void* sweeps, int batch, int n, int len,
                   float threshold, int csize, void* stream) {
  using C2 = typename Complex2<T>::type;
  if (batch < 1 || n < 4 || n % 2 || len < 1 || csize < 1 || csize > kMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(batch, n, csize, attr, stream);
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, jacobi_sv_cluster_kernel<T>, static_cast<C2*>(X),
      static_cast<const int*>(sched), static_cast<const Acc*>(prev),
      static_cast<Acc*>(measure), static_cast<int*>(done),
      static_cast<unsigned long long*>(sweeps), batch, n, len, threshold);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- kernel 2

template <typename T>
__global__ void jacobi_sweep_v_kernel(typename Complex2<T>::type* __restrict__ X,
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
  C2* Vb = V + static_cast<size_t>(blockIdx.x) * n * n;

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
      rotate_rows<T>(u_row, v_row, len, lane, q);
      rotate_rows<T>(Vb + static_cast<size_t>(l) * n, Vb + static_cast<size_t>(r) * n,
                     n, lane, q);
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

template <typename T>
int launch_v(void* X, void* V, const void* sched, void* measure, int batch, int n,
             int len, void* stream) {
  const int k = n / 2;
  const int warps = k < kMaxWarps ? k : kMaxWarps;
  const size_t shmem = static_cast<size_t>(n + kMaxWarps) * sizeof(Acc);
  using C2 = typename Complex2<T>::type;
  jacobi_sweep_v_kernel<T>
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
        rotate_rows<T, kGroup>(u_row, v_row, len, lane, q);
        rotate_rows<T, kGroup>(Ws + static_cast<size_t>(l) * n,
                               Ws + static_cast<size_t>(r) * n, n, lane, q);
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

// Kernel 1, shared-memory variant.  X complex [batch, n, len] (16-byte
// aligned) is rotated in place by one sweep unless the exit test skips it;
// sched int32 [n-1, n]; prev float64 [batch], the measures of the loop's
// previous launch, or null for its first (then no exit test); measure
// float64 [batch] is written with this sweep's measures; done int32 is the
// loop's exit flag (0 before its first launch); sweeps int64 counts the
// sweeps run; pairs uint16 [batch, n-1, n/2] is the sweep's scratch (the
// live pairs of each step); pair_steps int64 [2] counts the pair-steps run
// on two live rows and the pair-steps scheduled.  Enqueues one launch on
// `stream` without synchronizing; returns the launch's error,
// cudaErrorInvalidValue for a shape it does not take.
extern "C" int tct_jacobi_sweep_c64(void* X, const void* sched, const void* prev,
                                    void* measure, void* done, void* sweeps,
                                    void* pairs, void* pair_steps, int batch, int n,
                                    int len, float threshold, void* stream) {
  return launch_smem<float>(X, sched, prev, measure, done, sweeps, pairs, pair_steps,
                            batch, n, len, threshold, stream);
}

extern "C" int tct_jacobi_sweep_c128(void* X, const void* sched, const void* prev,
                                     void* measure, void* done, void* sweeps,
                                     void* pairs, void* pair_steps, int batch, int n,
                                     int len, float threshold, void* stream) {
  return launch_smem<double>(X, sched, prev, measure, done, sweeps, pairs, pair_steps,
                             batch, n, len, threshold, stream);
}

// CTAs of the shared-memory variant one SM holds at once for a [n, len]
// matrix (cudaOccupancyMaxActiveBlocksPerMultiprocessor): a batch above
// 132 times *blocks runs in more than one wave.
extern "C" int tct_jacobi_sweep_smem_occupancy_c64(int n, int len, int* blocks) {
  return smem_occupancy<float>(n, len, blocks);
}

extern "C" int tct_jacobi_sweep_smem_occupancy_c128(int n, int len, int* blocks) {
  return smem_occupancy<double>(n, len, blocks);
}

// Kernel 1, cluster variant: as above, with `cluster` CTAs per matrix (1..8,
// from the plan below) before the stream.
extern "C" int tct_jacobi_sweep_cluster_c64(void* X, const void* sched,
                                            const void* prev, void* measure,
                                            void* done, void* sweeps, int batch,
                                            int n, int len, float threshold,
                                            int cluster, void* stream) {
  return launch_cluster<float>(X, sched, prev, measure, done, sweeps, batch, n, len,
                               threshold, cluster, stream);
}

extern "C" int tct_jacobi_sweep_cluster_c128(void* X, const void* sched,
                                             const void* prev, void* measure,
                                             void* done, void* sweeps, int batch,
                                             int n, int len, float threshold,
                                             int cluster, void* stream) {
  return launch_cluster<double>(X, sched, prev, measure, done, sweeps, batch, n,
                                len, threshold, cluster, stream);
}

// The cluster size for a [batch, n, len] call: *cluster the largest size
// whose `batch` clusters the card keeps resident at once (else 1), *active
// the card's count of co-resident clusters of that size.
extern "C" int tct_jacobi_sweep_cluster_plan_c64(int batch, int n, int len,
                                                 int* cluster, int* active) {
  return cluster_plan<float>(batch, n, len, cluster, active);
}

extern "C" int tct_jacobi_sweep_cluster_plan_c128(int batch, int n, int len,
                                                  int* cluster, int* active) {
  return cluster_plan<double>(batch, n, len, cluster, active);
}

// Kernel 2, per sweep: X complex [batch, n, len] and W complex [batch, n, n]
// (rows = columns of V) are rotated in place by one sweep; sched int32
// [n-1, n], measure float64 [batch].  Enqueues one sweep on `stream`
// without synchronizing; returns cudaGetLastError().
extern "C" int tct_jacobi_sweep_v_c64(void* X, void* W, const void* sched,
                                      void* measure, int batch, int n, int len,
                                      void* stream) {
  return launch_v<float>(X, W, sched, measure, batch, n, len, stream);
}

extern "C" int tct_jacobi_sweep_v_c128(void* X, void* W, const void* sched,
                                       void* measure, int batch, int n, int len,
                                       void* stream) {
  return launch_v<double>(X, W, sched, measure, batch, n, len, stream);
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
