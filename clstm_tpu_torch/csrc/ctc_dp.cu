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
// What bounds them: a serial chain of T dependent steps per row, each a
// handful of flops per state (S <= 512 in practice, 81 at the bench shape)
// plus one block barrier for the shift of the state vector. Latency, not
// bytes (lmatch + lr + both are ~0.25 GB at the bench shape) or flops.
// Design: one block per row, one thread per state (a thread walks several
// states when S > 1024), the state vector double-buffered in shared memory
// so each step needs one barrier. Any B, T, S >= 1: no padding of S to 128
// or of B to 8. At the bench shape only B = 256 blocks of 96 threads run:
// the card is mostly idle, and the time is T steps of barrier and load
// latency.
//
// logaddexp is max + log1p(exp(min - max)): finite at NEG = -1e30 and at
// sums of several NEGs (never inf - inf).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1e30f;

__device__ __forceinline__ float logaddexp_f32(float a, float b) {
  const float m = fmaxf(a, b);
  return m + log1pf(expf(fminf(a, b) - m));
}

__device__ __forceinline__ int clamp_len(const int32_t* lengths, int b,
                                         int hi) {
  return min(max((int)lengths[b], 0), hi);
}

__global__ void ctc_forward_kernel(const float* __restrict__ lmatch,
                                   const int32_t* __restrict__ lengths,
                                   float* __restrict__ lr, int T, int S,
                                   float skip) {
  extern __shared__ float smem[];
  float* v = smem;        // [S] current state
  float* vn = smem + S;   // [S] next state
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

// BOTH: K6 (both = lr + u and lse); !BOTH: K6b (rl = u into `out`; lr and
// lse unused).
template <bool BOTH>
__global__ void ctc_both_kernel(const float* __restrict__ lmatch,
                                const float* __restrict__ lr,
                                const int32_t* __restrict__ lengths,
                                const int32_t* __restrict__ target_lengths,
                                float* __restrict__ out,
                                float* __restrict__ lse, int T, int S,
                                float skip) {
  extern __shared__ float smem[];
  float* u = smem;            // [S] current state
  float* un = smem + S;       // [S] next state
  float* mx = smem + 2 * S;   // [S] running max of both over t (BOTH)
  float* ac = smem + 3 * S;   // [S] running sum of exp(both - max) (BOTH)
  const int b = blockIdx.x;
  const int L = clamp_len(lengths, b, T);
  const int TL = target_lengths[b];
  const size_t row = (size_t)b * T * S;

  // Frames t >= len: both = NEG, and they enter the running pair like any
  // other frame (per state, no shift, so no barrier); rl = the initial u.
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    const float u0 = s < TL ? skip * (float)(TL - 1 - s) : NEG;
    u[s] = u0;
    float m = NEG, a = 0.0f;
    for (int t = T - 1; t >= L; --t) {
      if (BOTH) {
        out[row + (size_t)t * S + s] = NEG;
        const float m2 = fmaxf(m, NEG);
        a = a * expf(m - m2) + expf(NEG - m2);
        m = m2;
      } else {
        out[row + (size_t)t * S + s] = u0;
      }
    }
    if (BOTH) {
      mx[s] = m;
      ac[s] = a;
    }
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
        const float m = mx[s];
        const float m2 = fmaxf(m, bo);
        ac[s] = ac[s] * expf(m - m2) + expf(bo - m2);
        mx[s] = m2;
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

int block_threads(int S) {
  int threads = ((S + 31) / 32) * 32;
  return threads > 1024 ? 1024 : threads;
}

cudaError_t set_smem(const void* fn, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace

// Each entry launches on `stream` and returns cudaGetLastError() (0 on
// success). All pointers are device pointers; B, T, S >= 1.
extern "C" int clstm_ctc_forward(const float* lmatch, const int32_t* lengths,
                                 float* lr, int B, int T, int S, float skip,
                                 void* stream) {
  const size_t smem = 2 * (size_t)S * sizeof(float);
  const cudaError_t e = set_smem((const void*)ctc_forward_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  ctc_forward_kernel<<<B, block_threads(S), smem, (cudaStream_t)stream>>>(
      lmatch, lengths, lr, T, S, skip);
  return (int)cudaGetLastError();
}

extern "C" int clstm_ctc_both(const float* lmatch, const float* lr,
                              const int32_t* lengths,
                              const int32_t* target_lengths, float* both,
                              float* lse, int B, int T, int S, float skip,
                              void* stream) {
  const size_t smem = 4 * (size_t)S * sizeof(float);
  const cudaError_t e = set_smem((const void*)ctc_both_kernel<true>, smem);
  if (e != cudaSuccess) return (int)e;
  ctc_both_kernel<true><<<B, block_threads(S), smem, (cudaStream_t)stream>>>(
      lmatch, lr, lengths, target_lengths, both, lse, T, S, skip);
  return (int)cudaGetLastError();
}

// K6b: rl [B,T,S] from lmatch [B,T,S], lengths and target_lengths [B].
extern "C" int clstm_ctc_backward(const float* lmatch, const int32_t* lengths,
                                  const int32_t* target_lengths, float* rl,
                                  int B, int T, int S, float skip,
                                  void* stream) {
  const size_t smem = 2 * (size_t)S * sizeof(float);
  const cudaError_t e = set_smem((const void*)ctc_both_kernel<false>, smem);
  if (e != cudaSuccess) return (int)e;
  ctc_both_kernel<false><<<B, block_threads(S), smem,
                           (cudaStream_t)stream>>>(
      lmatch, nullptr, lengths, target_lengths, rl, nullptr, T, S, skip);
  return (int)cudaGetLastError();
}
