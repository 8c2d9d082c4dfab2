// CTC alignment DP kernels, f32, for sm_90a.
//
// K5 clstm_ctc_forward replaces clstm_tpu/ops/pallas_ctc.py::_kernel
// (ctc_forward_pallas); K6 clstm_ctc_both replaces pallas_ctc.py::_bwd_kernel
// with fuse_both=True (ctc_both_pallas); K6b clstm_ctc_backward replaces the
// same kernel with fuse_both=False (ctc_backward_pallas), and is a mode of
// K6's kernel. Contracts, as the plain versions
// clstm_tpu_torch/ops/ctc.py::ctc_forward_plain, ctc_both_plain and
// ctc_backward_plain:
//
//   K5: lmatch [B,T,S], lengths [B] -> lr [B,T,S]
//       v0[s] = skip*s; per frame t < len: w[s] = v[s-1], w[0] = skip*t;
//       v = logaddexp(v + lm_t, w + lm_t); lr[t] = v. Frames t >= len carry
//       v through (lr[t] = the last v).
//   K6: lmatch, lr [B,T,S], lengths, target_lengths [B]
//       -> both [B,T,S], lse [B,S]
//       u[s] = skip*(tlen-1-s), NEG for s >= tlen; per frame t from len-1
//       down to 0: w[s] = u[s+1] (NEG past the last state), the boundary
//       column s = tlen-1 set to skip*(len-1-t); u = logaddexp(u + lm_t,
//       w + lm_t); both[t] = lr[t] + u. Frames t >= len: both = NEG.
//       lse[s] = logsumexp over all T frames of both[., s], by a running
//       max / scaled-sum pair (exact, no overflow).
//   K6b: lmatch [B,T,S], lengths, target_lengths [B] -> rl [B,T,S]: K6's
//       recurrence alone, rl[t] = u after frame t. Frames t >= len carry u
//       through (rl = the initial u there, as the TPU kernel writes). On
//       valid cells (t < len, s < tlen) rl equals the flip recipe of
//       ctc_backward_plain; elsewhere the two differ freely.
//
// Any B, T >= 1 and any S >= 1 that a block's shared memory holds in the
// wide branch (below): S up to 14,528 in K6 and 29,056 in K5 and K6b. No
// padding of S to 128 or of B to 8.
//
// What bounds them: the dependent chain of len steps per row. A step is a
// few flops per state and one logaddexp, whose accurate expf and log1pf
// make ~45 dependent instructions; the bytes (lmatch, lr and both, ~0.25 GB
// at B=256, T=1024, S=81) would take ~0.08 ms, and at B=256 the card has
// a few warps of work per SM. So the time is len x (the latency of one
// step), and the design keeps everything else off that chain:
//   - A row runs on one block of W warps, lane l of warp w holding the K
//     contiguous states from (w·32 + l)·K in registers (the plan, below:
//     W=3, K=1 at S=81). The shift by one state is one __shfl_up/__shfl_down
//     a step; the edge state crosses to the next warp through shared memory
//     and one barrier of the row's warps (W > 1 only). The boundary column
//     (s = 0 in K5, s = tlen-1 in K6) falls in whatever lane holds it. Three
//     warps of one state a lane ran faster at S=81 than one warp of three or
//     two of two (PERF.md §6); the cause, one warp's own instruction stream
//     holding three logaddexps a step, is inferred, not measured.
//   - lmatch (and K6's lr) stream into a ring of P frames in shared memory
//     by cp.async, P-1 frames ahead of the step that reads them; each lane
//     copies and reads only its own states, so no barrier guards the ring,
//     and a step waits only on cp.async.wait_group. (A ring in registers
//     did not hide the loads: the compiler moved each loaded value into its
//     slot right after the load.)
//   - K6's running pair takes one expf per cell (the max/min form, equal to
//     the two-expf update) and feeds nothing back into the chain. Its
//     padded frames start it at the closed form m = NEG, a = T - len (what
//     the updates over len..T-1 with both = NEG give, exactly).
//   - Stores go straight from registers; K6's NEG frames are one coalesced
//     sweep over the row's contiguous padded tail.
// Above 2,048 states (32 warps of 2) the wide branch (K = 0 in the plan):
// the states double-buffered in shared memory, thread i of the row's block
// walking states i, i + 1024, ..., one barrier a frame, lmatch and lr read
// at their frame; K6's running pair in shared memory beside the states.
// No caller sends such rows (S_BUCKETS ends at 512); the branch keeps the
// widths the kernels took before the register design.
// The plan (W warps a row, K states a lane, P frames in flight) is
// ops/ctc_kernel.py::ctc_dp_plan; a (K, P) pair has to be an instance below
// (CTC_INSTANCES), and clstm_ctc_config reports them.
//
// logaddexp is max + log1p(exp(min - max)) with the accurate expf and
// log1pf (no fast math): finite at NEG = -1e30 and at sums of several NEGs
// (never inf - inf). Fixed order, no atomics: two calls give equal bits.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;
// A row's warps at most: one block of 1,024 threads, 64 registers each
// (K6 keeps ~6·K floats live; `nvcc -Xptxas -v`: no spills).
constexpr int MAX_WARPS = 32;
constexpr int SMEM_MAX = 232448;

// (states per lane K, frames in flight P) pairs compiled. ctc_dp_plan
// takes K = 1 or 2; K = 3 is the one-warp layout at S=81, compiled to be
// timed in turns against the plan's choice (chip_smoke.py).
#define CTC_INSTANCES(X) X(1, 16) X(2, 8) X(3, 8)

__device__ __forceinline__ float logaddexp_f32(float a, float b) {
  const float m = fmaxf(a, b);
  return m + log1pf(expf(fminf(a, b) - m));
}

__device__ __forceinline__ int clamp_len(const int32_t* lengths, int b,
                                         int hi) {
  return min(max((int)lengths[b], 0), hi);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits until at most N of this thread's groups are in flight.
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A lane's place: the block is row blockIdx.x on W warps; lane l of warp w
// (thread w·32 + l) owns states [s0, s0 + K), s0 = (w·32 + l)·K. States >= S
// are computed on the last state's inputs but neither feed a real state
// nor are stored. The rings are [P][32·W·K] floats in shared memory, frame
// f in slot f mod P; a lane copies and reads only its own states there.
template <int K>
struct Lane {
  int lane, warp, s0, off[K];
  __device__ __forceinline__ explicit Lane(int S) {
    lane = threadIdx.x & 31;
    warp = threadIdx.x >> 5;
    s0 = threadIdx.x * K;
#pragma unroll
    for (int k = 0; k < K; ++k) off[k] = min(s0 + k, S - 1);
  }
};

// Starts the copy of this lane's states of `frame` into a ring's `slot`.
template <int K>
__device__ __forceinline__ void fetch(float* slot, const float* frame,
                                      const Lane<K>& q) {
#pragma unroll
  for (int k = 0; k < K; ++k) cp_async4(slot + q.s0 + k, frame + q.off[k]);
}

template <int K>
__device__ __forceinline__ void read_slot(float (&dst)[K],
                                          const float* slot, int s0) {
#pragma unroll
  for (int k = 0; k < K; ++k) dst[k] = slot[s0 + k];
}

template <int K>
__device__ __forceinline__ void store_frame(float* __restrict__ dst,
                                            const float (&v)[K], int n) {
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (k < n) dst[k] = v[k];
}

// One step of K5 at frame t: v = logaddexp(v + l, w + l), w[s] = v[s-1],
// w[0] = skip·t. With MULTI, a warp's edge state crosses to the next
// warp through `bar` and one barrier of the row's warps.
template <int K, bool MULTI>
__device__ __forceinline__ void forward_step(float (&v)[K],
                                             const float (&l)[K], int t,
                                             float skip, const Lane<K>& q,
                                             float* bar) {
  float e = __shfl_up_sync(FULL, v[K - 1], 1);
  if constexpr (MULTI) {
    if (q.lane == 31) bar[(t & 1) * MAX_WARPS + q.warp] = v[K - 1];
    __syncthreads();
    if (q.lane == 0 && q.warp > 0) e = bar[(t & 1) * MAX_WARPS + q.warp - 1];
  }
  if (q.s0 == 0) e = skip * (float)t;
  float nv[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float w = k == 0 ? e : v[k - 1];
    nv[k] = logaddexp_f32(v[k] + l[k], w + l[k]);
  }
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = nv[k];
}

template <int K, int P, bool MULTI>
__global__ void __launch_bounds__(32 * MAX_WARPS, 1)
    ctc_forward_kernel(const float* __restrict__ lmatch,
                       const int32_t* __restrict__ lengths,
                       float* __restrict__ lr, int T, int S, float skip,
                       int W) {
  extern __shared__ float smem[];
  const Lane<K> q(S);
  const int pitch = 32 * W * K;
  float* bar = smem + (size_t)P * pitch;
  const int b = blockIdx.x;
  const int L = clamp_len(lengths, b, T);
  const float* src = lmatch + (size_t)b * T * S;
  float* dst = lr + (size_t)b * T * S + q.s0;
  const int n = S - q.s0;

  float v[K];
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = skip * (float)(q.s0 + k);
  // Frames 0..P-2 in flight; step t starts frame t+P-1 and waits for frame
  // t. Frames past the row's end are fetched (clamped to T-1), never read.
  for (int f = 0; f < P - 1; ++f) {
    fetch(smem + (f & (P - 1)) * pitch, src + (size_t)min(f, T - 1) * S, q);
    cp_commit();
  }
  for (int t = 0; t < L; ++t) {
    const int f = t + P - 1;
    fetch(smem + (f & (P - 1)) * pitch, src + (size_t)min(f, T - 1) * S, q);
    cp_commit();
    cp_wait<P - 1>();
    // Read before the step's barrier, which the compiler does not move
    // shared-memory loads across.
    float l[K];
    read_slot<K>(l, smem + (t & (P - 1)) * pitch, q.s0);
    forward_step<K, MULTI>(v, l, t, skip, q, bar);
    store_frame<K>(dst, v, n);
    dst += S;
  }
  cp_wait<0>();
  for (int t = L; t < T; ++t, dst += S) store_frame<K>(dst, v, n);
}

// One step of K6/K6b (step i = len-1-t): u = logaddexp(u + l, w + l),
// w[s] = u[s+1], NEG past the last state, skip·i at s = tlen-1.
template <int K, bool MULTI>
__device__ __forceinline__ void both_step(float (&u)[K], const float (&l)[K],
                                          int i, float skip, int kb, int kend,
                                          int W, const Lane<K>& q,
                                          float* bar) {
  float e = __shfl_down_sync(FULL, u[0], 1);
  if constexpr (MULTI) {
    if (q.lane == 0) bar[(i & 1) * MAX_WARPS + q.warp] = u[0];
    __syncthreads();
    if (q.lane == 31 && q.warp < W - 1)
      e = bar[(i & 1) * MAX_WARPS + q.warp + 1];
  }
  const float wb = skip * (float)i;
  float nu[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float w = k < K - 1 ? u[k + 1] : e;
    if (k >= kend) w = NEG;
    if (k == kb) w = wb;
    nu[k] = logaddexp_f32(u[k] + l[k], w + l[k]);
  }
#pragma unroll
  for (int k = 0; k < K; ++k) u[k] = nu[k];
}

// K6's running pair, one cell: m2 = max(m, bo); a = a·exp(m - m2) +
// exp(bo - m2), with the factor that is exp(0) = 1 left out.
__device__ __forceinline__ void pair_update(float& m, float& a, float bo) {
  const float hi = fmaxf(m, bo);
  const float x = expf(fminf(m, bo) - hi);
  a = bo > m ? fmaf(a, x, 1.0f) : a + x;
  m = hi;
}

// BOTH: K6 (both = lr + u and lse; two rings, lmatch's and lr's); !BOTH:
// K6b (rl = u into `out`; lr and lse unused). Step i runs frame
// t = len-1-i.
template <int K, int P, bool MULTI, bool BOTH>
__global__ void __launch_bounds__(32 * MAX_WARPS, 1)
    ctc_both_kernel(const float* __restrict__ lmatch,
                    const float* __restrict__ lr,
                    const int32_t* __restrict__ lengths,
                    const int32_t* __restrict__ target_lengths,
                    float* __restrict__ out, float* __restrict__ lse, int T,
                    int S, float skip, int W) {
  extern __shared__ float smem[];
  constexpr int NR = BOTH ? 2 : 1;
  const Lane<K> q(S);
  const int pitch = 32 * W * K;
  float* ringr = smem + P * pitch;
  float* bar = smem + (size_t)NR * P * pitch;
  const int b = blockIdx.x;
  const int L = clamp_len(lengths, b, T);
  const int TL = target_lengths[b];
  const size_t row = (size_t)b * T * S;
  const float* src = lmatch + row;
  const float* srcr = BOTH ? lr + row : nullptr;
  float* dst = out + row + (size_t)max(L - 1, 0) * S + q.s0;
  const int n = S - q.s0;
  // Where this lane's run holds the boundary column s = tlen-1 (if at all),
  // and the first of its states whose right neighbour is past the last.
  const int kb = TL - 1 - q.s0;
  const int kend = S - 1 - q.s0;

  float u[K], m[K], a[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int s = q.s0 + k;
    u[k] = s < TL ? skip * (float)(TL - 1 - s) : NEG;
    // Frames len..T-1 enter the pair with both = NEG: each update leaves
    // m = NEG and adds exp(0) = 1 to a.
    m[k] = NEG;
    a[k] = (float)(T - L);
  }
  // As in K5, with frames counted down from len-1 (clamped to 0).
  for (int j = 0; j < P - 1; ++j) {
    const size_t f = (size_t)max(L - 1 - j, 0) * S;
    fetch(smem + (j & (P - 1)) * pitch, src + f, q);
    if constexpr (BOTH) fetch(ringr + (j & (P - 1)) * pitch, srcr + f, q);
    cp_commit();
  }
  for (int i = 0; i < L; ++i) {
    const int j = i + P - 1;
    const size_t f = (size_t)max(L - 1 - j, 0) * S;
    fetch(smem + (j & (P - 1)) * pitch, src + f, q);
    if constexpr (BOTH) fetch(ringr + (j & (P - 1)) * pitch, srcr + f, q);
    cp_commit();
    cp_wait<P - 1>();
    float l[K], r[K];
    read_slot<K>(l, smem + (i & (P - 1)) * pitch, q.s0);
    if constexpr (BOTH) read_slot<K>(r, ringr + (i & (P - 1)) * pitch, q.s0);
    both_step<K, MULTI>(u, l, i, skip, kb, kend, W, q, bar);
    if constexpr (BOTH) {
      float bo[K];
#pragma unroll
      for (int k = 0; k < K; ++k) bo[k] = r[k] + u[k];
      store_frame<K>(dst, bo, n);
#pragma unroll
      for (int k = 0; k < K; ++k) pair_update(m[k], a[k], bo[k]);
    } else {
      store_frame<K>(dst, u, n);
    }
    dst -= S;
  }
  cp_wait<0>();
  if constexpr (BOTH) {
    // Frames len..T-1 are the row's contiguous tail: NEG, coalesced.
    float* tail = out + row + (size_t)L * S;
    const size_t count = (size_t)(T - L) * S;
    for (size_t j = threadIdx.x; j < count; j += blockDim.x) tail[j] = NEG;
    float z[K];
#pragma unroll
    for (int k = 0; k < K; ++k) z[k] = m[k] + logf(fmaxf(a[k], 1e-30f));
    store_frame<K>(lse + (size_t)b * S + q.s0, z, n);
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int s = q.s0 + k;
      u[k] = s < TL ? skip * (float)(TL - 1 - s) : NEG;
    }
    float* pad = out + row + (size_t)L * S + q.s0;
    for (int t = L; t < T; ++t, pad += S) store_frame<K>(pad, u, n);
  }
}

// The wide branch of K5: the state double-buffered in shared memory [2][S].
__global__ void __launch_bounds__(32 * MAX_WARPS)
    ctc_forward_wide(const float* __restrict__ lmatch,
                     const int32_t* __restrict__ lengths,
                     float* __restrict__ lr, int T, int S, float skip) {
  extern __shared__ float smem[];
  float* v = smem;
  float* vn = smem + S;
  const int b = blockIdx.x;
  const int L = clamp_len(lengths, b, T);
  const float* lm = lmatch + (size_t)b * T * S;
  float* out = lr + (size_t)b * T * S;

  for (int s = threadIdx.x; s < S; s += blockDim.x) v[s] = skip * (float)s;
  __syncthreads();
  for (int t = 0; t < L; ++t) {
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
      const float l = lm[(size_t)t * S + s];
      const float w = s == 0 ? skip * (float)t : v[s - 1];
      const float nv = logaddexp_f32(v[s] + l, w + l);
      vn[s] = nv;
      out[(size_t)t * S + s] = nv;
    }
    __syncthreads();
    float* tmp = v;
    v = vn;
    vn = tmp;
  }
  for (int t = L; t < T; ++t)
    for (int s = threadIdx.x; s < S; s += blockDim.x)
      out[(size_t)t * S + s] = v[s];
}

// The wide branch of K6 (BOTH) and K6b: the state double-buffered in
// shared memory, and K6's running pair beside it ([4][S] floats; [2][S] in
// K6b).
template <bool BOTH>
__global__ void __launch_bounds__(32 * MAX_WARPS)
    ctc_both_wide(const float* __restrict__ lmatch,
                  const float* __restrict__ lr,
                  const int32_t* __restrict__ lengths,
                  const int32_t* __restrict__ target_lengths,
                  float* __restrict__ out, float* __restrict__ lse, int T,
                  int S, float skip) {
  extern __shared__ float smem[];
  float* u = smem;
  float* un = smem + S;
  float* mx = smem + 2 * S;
  float* ac = smem + 3 * S;
  const int b = blockIdx.x;
  const int L = clamp_len(lengths, b, T);
  const int TL = target_lengths[b];
  const size_t row = (size_t)b * T * S;

  // Frames t >= len: both = NEG (the pair's closed form), rl = the
  // initial u.
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    const float u0 = s < TL ? skip * (float)(TL - 1 - s) : NEG;
    u[s] = u0;
    if (BOTH) {
      mx[s] = NEG;
      ac[s] = (float)(T - L);
    }
    for (int t = L; t < T; ++t)
      out[row + (size_t)t * S + s] = BOTH ? NEG : u0;
  }
  __syncthreads();
  for (int t = L - 1; t >= 0; --t) {
    const float wb = skip * (float)(L - 1 - t);
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
      const size_t i = row + (size_t)t * S + s;
      const float l = lmatch[i];
      const float w = s == TL - 1 ? wb : (s + 1 < S ? u[s + 1] : NEG);
      const float nu = logaddexp_f32(u[s] + l, w + l);
      un[s] = nu;
      if (BOTH) {
        const float bo = lr[i] + nu;
        out[i] = bo;
        pair_update(mx[s], ac[s], bo);
      } else {
        out[i] = nu;
      }
    }
    __syncthreads();
    float* tmp = u;
    u = un;
    un = tmp;
  }
  if (BOTH)
    for (int s = threadIdx.x; s < S; s += blockDim.x)
      lse[(size_t)b * S + s] = mx[s] + logf(fmaxf(ac[s], 1e-30f));
}

// The plan checked: W warps a row (each with states), K states a lane in
// registers, or K = 0 (the wide branch) with P = 0.
bool plan_ok(int B, int T, int S, int W, int K, int P) {
  if (B < 1 || T < 1 || S < 1 || W < 1 || W > MAX_WARPS || K < 0)
    return false;
  if (K == 0) return P == 0;
  return (long long)32 * W * K >= S && (long long)32 * (W - 1) * K < S;
}

// Bytes of shared memory a block of the plan takes with `nrings` rings (K6
// 2, K5 and K6b 1): the rings of P frames of 32·W·K floats and the edge
// slots [2][MAX_WARPS]; in the wide branch, 2·nrings arrays of S floats.
size_t smem_bytes(int S, int W, int K, int P, int nrings) {
  if (K == 0) return sizeof(float) * 2 * nrings * (size_t)S;
  return sizeof(float) *
         ((size_t)nrings * P * 32 * W * K + 2 * MAX_WARPS);
}

// Calls f(integral_constant<K>, integral_constant<P>) for a compiled
// instance, else returns cudaErrorInvalidValue.
template <class F>
cudaError_t with_instance(int K, int P, F&& f) {
#define CTC_CASE(k, p)                         \
  if (K == k && P == p)                        \
    return f(std::integral_constant<int, k>{}, \
             std::integral_constant<int, p>{});
  CTC_INSTANCES(CTC_CASE)
#undef CTC_CASE
  return cudaErrorInvalidValue;
}

// One block of W warps for each of the B rows.
template <class Kern, class... Args>
cudaError_t launch(Kern kern, int B, int W, size_t smem, void* stream,
                   Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<B, 32 * W, smem, (cudaStream_t)stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace

// Each entry launches on `stream` and returns cudaGetLastError() (0 on
// success). All pointers are device pointers; B, T, S >= 1. The plan (W
// warps a row, K states a lane or 0 for the wide branch, P frames in
// flight) comes from ops/ctc_kernel.py::ctc_dp_plan; one the kernels do not
// take, or whose shared memory passes a block's, returns
// cudaErrorInvalidValue.
extern "C" int clstm_ctc_forward(const float* lmatch, const int32_t* lengths,
                                 float* lr, int B, int T, int S, int W, int K,
                                 int P, float skip, void* stream) {
  const size_t smem = smem_bytes(S, W, K, P, 1);
  if (!plan_ok(B, T, S, W, K, P) || smem > SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  if (K == 0)
    return (int)launch(ctc_forward_wide, B, W, smem, stream, lmatch, lengths,
                       lr, T, S, skip);
  return (int)with_instance(K, P, [&](auto k, auto p) {
    constexpr int KK = decltype(k)::value, PP = decltype(p)::value;
    return launch(W > 1 ? ctc_forward_kernel<KK, PP, true>
                        : ctc_forward_kernel<KK, PP, false>,
                  B, W, smem, stream, lmatch, lengths, lr, T, S, skip, W);
  });
}

extern "C" int clstm_ctc_both(const float* lmatch, const float* lr,
                              const int32_t* lengths,
                              const int32_t* target_lengths, float* both,
                              float* lse, int B, int T, int S, int W, int K,
                              int P, float skip, void* stream) {
  const size_t smem = smem_bytes(S, W, K, P, 2);
  if (!plan_ok(B, T, S, W, K, P) || smem > SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  if (K == 0)
    return (int)launch(ctc_both_wide<true>, B, W, smem, stream, lmatch, lr,
                       lengths, target_lengths, both, lse, T, S, skip);
  return (int)with_instance(K, P, [&](auto k, auto p) {
    constexpr int KK = decltype(k)::value, PP = decltype(p)::value;
    return launch(W > 1 ? ctc_both_kernel<KK, PP, true, true>
                        : ctc_both_kernel<KK, PP, false, true>,
                  B, W, smem, stream, lmatch, lr, lengths, target_lengths,
                  both, lse, T, S, skip, W);
  });
}

// K6b: rl [B,T,S] from lmatch [B,T,S], lengths and target_lengths [B].
extern "C" int clstm_ctc_backward(const float* lmatch, const int32_t* lengths,
                                  const int32_t* target_lengths, float* rl,
                                  int B, int T, int S, int W, int K, int P,
                                  float skip, void* stream) {
  const size_t smem = smem_bytes(S, W, K, P, 1);
  if (!plan_ok(B, T, S, W, K, P) || smem > SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  const float* none = nullptr;
  if (K == 0)
    return (int)launch(ctc_both_wide<false>, B, W, smem, stream, lmatch,
                       none, lengths, target_lengths, rl, (float*)nullptr, T,
                       S, skip);
  return (int)with_instance(K, P, [&](auto k, auto p) {
    constexpr int KK = decltype(k)::value, PP = decltype(p)::value;
    return launch(W > 1 ? ctc_both_kernel<KK, PP, true, false>
                        : ctc_both_kernel<KK, PP, false, false>,
                  B, W, smem, stream, lmatch, none, lengths, target_lengths,
                  rl, (float*)nullptr, T, S, skip, W);
  });
}

// Bytes of shared memory a block of the plan takes with `nrings` rings (K6
// 2, K5 and K6b 1), or 0 if the library has no kernel for the plan.
extern "C" long long clstm_ctc_smem(int S, int W, int K, int P, int nrings) {
  const size_t smem = smem_bytes(S, W, K, P, nrings);
  if (!plan_ok(1, 1, S, W, K, P) || smem > SMEM_MAX) return 0;
  if (K == 0) return (long long)smem;
  return with_instance(K, P, [](auto, auto) { return cudaSuccess; }) ==
                 cudaSuccess
             ? (long long)smem
             : 0;
}

// What the library was built with, for ops/ctc_kernel.py to check its
// constants against: MAX_WARPS, SMEM_MAX, then K and P of each instance.
// Writes at most n ints to out and returns how many there are.
extern "C" int clstm_ctc_config(int* out, int n) {
  int v[64], c = 0;
  v[c++] = MAX_WARPS;
  v[c++] = SMEM_MAX;
#define CTC_PAIR(k, p) \
  v[c++] = k;          \
  v[c++] = p;
  CTC_INSTANCES(CTC_PAIR)
#undef CTC_PAIR
  for (int i = 0; i < c && i < n; ++i) out[i] = v[i];
  return c;
}
