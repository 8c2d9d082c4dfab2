// Bidirectional LSTM forward, f32, for sm_90a, in four modes of one kernel
// (template flags EMIT and HOIST):
//
//   K3 (EMIT=false, HOIST=false, clstm_bidi_lstm_fwd): replaces the TPU
//   kernel clstm_tpu/ops/pallas_lstm.py::_fwd_kernel with emit_state=False,
//   proj_in=False (bidi_lstm_pallas(..., with_state=False), serving).
//   K1 (EMIT=true, HOIST=false, clstm_bidi_lstm_fwd_state): replaces the same
//   kernel with emit_state=True (the forward of bidi_lstm_pallas's custom
//   VJP, training). It also writes what the backward kernel K2 reads.
//   K4 (HOIST=true, clstm_bidi_lstm_fwd_xz and clstm_bidi_lstm_fwd_xz_state,
//   EMIT as for K3 and K1): replaces _fwd_kernel with proj_in=True, which
//   the JAX package takes when D+1 > ceil(H/128)·128 (pallas_lstm.py:836;
//   the second layer of the bidi2 net). The input projection was hoisted
//   out of the recurrence into one product (xz, computed before the
//   launch, as _proj_stream is on the TPU); the kernel runs only the h·Wh
//   chain on it.
//
// Same contract as clstm_tpu_torch/ops/lstm.py::bidi_lstm_apply (K3),
// bidi_lstm_fwd_state_plain (K1), bidi_lstm_apply_xz and
// bidi_lstm_fwd_state_xz_plain (K4):
//
//   x [B,T,D] f32, lengths [B] int32 (or NULL: all T), fused weights per
//   direction Wx [D,4H], Wh [H,4H], b [4H], gate order (gi, gf, go, ci)
//   -> y [B,T,2H] f32, forward half then reverse half.
//   z = [x_t | 1]·[Wx; b] + h·Wh; gi, gf, go sigmoid; ci tanh;
//   c' = gf·c + gi·ci; h' = tanh(c')·go.
//   K4 reads z's first term from xz [B,T,2,4H] (xz[b,t,dir] = x_t·Wx_dir +
//   b_dir, original time order) in place of x, Wx and b.
//   The reverse direction starts from zero state at t = len-1 and walks
//   down to t = 0 (flip within length). y is exactly 0.0 on every frame
//   t >= len, in both halves, and on rows with len == 0. Lengths are
//   clamped to [0, T].
//   K1 and K4's state mode also write, in ORIGINAL time order per
//   direction, gates [B,T,2,4H] (the activated gi, gf, go, ci of each step)
//   and cell [B,T,2,H] (c after the step), both exactly 0 on frames
//   t >= len. K2 takes h_prev and c_prev from y and cell at the frame before
//   in chain order. Storing the activated gates (0.84 GB at B=256, T=1024,
//   H=100) spares K2 a second serial [x|1|h]·W product per step: on this
//   card the chain is bound by serial per-thread work, not by bytes (80 GB
//   of memory, ~3.35 TB/s).
//
// What bounds it: a serial chain of T steps per direction, each a
// [rows,D+1+H] x [D+1+H,4H] product followed by the gate math. At the
// serving shape (D=48, H=100) that is ~0.5 MFLOP per row tile per step:
// latency, not bytes or FLOPs, is the limit. A thread's serial work per step
// is ROWS·(D+1+H) multiply-adds; at the bidi2 net's second layer (D=400,
// H=200) that is 2,404, of which K4 keeps the ROWS·H = 800 of h·Wh and
// replaces the rest by ROWS coalesced loads of xz (1.68 GB per pass at
// B=256, T=1024, H=200, read once).
//
// Design (simple first; bf16 operands, mma/wgmma on the recurrent product
// and shared-memory staging of Wh are left for later work):
//   grid = (ceil(B / ROWS) row tiles, 2 directions); one block walks its
//   tile's time chain in a loop. h, c, x_t and z for the tile live in
//   shared memory. Phase 1: one thread per gate column j < 4H computes
//   z[r, j] for the tile's ROWS rows, reading Wx and Wh column-wise from
//   global memory (coalesced across j; 2·(D+1+H)·4H·4 B ≈ 477 KB for both
//   directions, resident in L2) — each weight read is reused ROWS times.
//   Without HOIST the input projection is computed here, inside the
//   kernel, as _fill_xz_split does on the TPU; with HOIST the thread starts
//   its sums from xz[b, t, dir, j] instead (no x_t staging; in state mode
//   loaded one step ahead into registers, see below). Phase 2: one
//   thread per (row, unit) applies the gates, updates c and h, writes y,
//   and loads the next step's x_t. Two barriers per step.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 4;

__device__ __forceinline__ float sigmoid_f32(float v) {
  return 1.0f / (1.0f + expf(-v));
}

// Load x_t for every row of the tile at chain step s into xs [ROWS, D]
// (zeros for rows whose chain has ended).
__device__ __forceinline__ void load_x(float* xs, const float* __restrict__ x,
                                       const int* lens, int b0, int s, int T,
                                       int D, int dir) {
  for (int i = threadIdx.x; i < ROWS * D; i += blockDim.x) {
    const int r = i / D;
    const int d = i - r * D;
    const int L = lens[r];
    float v = 0.0f;
    if (s < L) {
      const int t = dir == 0 ? s : L - 1 - s;
      v = x[((size_t)(b0 + r) * T + t) * D + d];
    }
    xs[i] = v;
  }
}

// xz of column j at chain step s for every row of the tile (zeros for rows
// whose chain has ended, and for j >= G).
__device__ __forceinline__ void load_xz_col(float (&v)[ROWS],
                                            const float* __restrict__ xz,
                                            const int* lens, int b0, int s,
                                            int T, int G, int dir, int j) {
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int L = lens[r];
    v[r] = 0.0f;
    if (j < G && s < L) {
      const int t = dir == 0 ? s : L - 1 - s;
      v[r] = xz[(((size_t)(b0 + r) * T + t) * 2 + dir) * G + j];
    }
  }
}

// x is xz [B,T,2,4H] when HOIST (wx and bias unused), else x [B,T,D].
template <bool EMIT, bool HOIST>
__global__ void bidi_lstm_fwd_kernel(const float* __restrict__ x,
                                     const int32_t* __restrict__ lengths,
                                     const float* __restrict__ wx,
                                     const float* __restrict__ wh,
                                     const float* __restrict__ bias,
                                     float* __restrict__ y,
                                     float* __restrict__ gates,
                                     float* __restrict__ cell, int B, int T,
                                     int D, int H) {
  extern __shared__ float smem[];
  __shared__ int lens[ROWS];
  const int G = 4 * H;
  float* xs = smem;            // [ROWS, D] (empty when HOIST)
  float* hs = xs + (HOIST ? 0 : ROWS * D);   // [ROWS, H]
  float* cs = hs + ROWS * H;   // [ROWS, H]
  float* zs = cs + ROWS * H;   // [ROWS, 4H]

  const int dir = blockIdx.y;
  const int b0 = blockIdx.x * ROWS;
  if (!HOIST) {
    wx += (size_t)dir * D * G;
    bias += (size_t)dir * G;
  }
  wh += (size_t)dir * H * G;

  if (threadIdx.x < ROWS) {
    const int b = b0 + threadIdx.x;
    int L = 0;
    if (b < B) L = lengths ? lengths[b] : T;
    lens[threadIdx.x] = min(max(L, 0), T);
  }
  for (int i = threadIdx.x; i < ROWS * H; i += blockDim.x) {
    hs[i] = 0.0f;
    cs[i] = 0.0f;
  }
  __syncthreads();
  int lmax = 0;
  for (int r = 0; r < ROWS; ++r) lmax = max(lmax, lens[r]);

  // Frames t >= len are padding in both halves: exact zeros.
  for (int r = 0; r < ROWS && b0 + r < B; ++r) {
    const int L = lens[r];
    for (int i = threadIdx.x; i < (T - L) * H; i += blockDim.x) {
      const int t = L + i / H;
      const int k = i - (t - L) * H;
      y[((size_t)(b0 + r) * T + t) * 2 * H + dir * H + k] = 0.0f;
      if (EMIT) {
        const size_t f = ((size_t)(b0 + r) * T + t) * 2 + dir;
        cell[f * H + k] = 0.0f;
        for (int g = 0; g < 4; ++g) gates[f * G + g * H + k] = 0.0f;
      }
    }
  }

  // K4's state mode: xz of the thread's first column, loaded one step
  // ahead at the start of phase 2, before that phase's five stores a
  // thread; loaded at the head of the chain, behind them, it waited for
  // them (20.5 against 14.0 ms at B=256, T=1024, H=200 on the card). K4's
  // inference mode loads it at the head of the chain, which measured
  // faster there (13.9 against 15.1 ms): PERF.md §6.
  [[maybe_unused]] float nxt[ROWS];
  if constexpr (HOIST && EMIT)
    load_xz_col(nxt, x, lens, b0, 0, T, G, dir, threadIdx.x);
  if constexpr (!HOIST) load_x(xs, x, lens, b0, 0, T, D, dir);
  __syncthreads();
  for (int s = 0; s < lmax; ++s) {
    // Phase 1: gate pre-activations z [ROWS, 4H].
    for (int j = threadIdx.x; j < G; j += blockDim.x) {
      float acc[ROWS];
      if constexpr (HOIST) {
        if (EMIT && j == (int)threadIdx.x) {
#pragma unroll
          for (int r = 0; r < ROWS; ++r) acc[r] = nxt[r];
        } else {
          load_xz_col(acc, x, lens, b0, s, T, G, dir, j);
        }
      } else {
        const float bj = bias[j];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) acc[r] = bj;
        for (int d = 0; d < D; ++d) {
          const float w = wx[(size_t)d * G + j];
#pragma unroll
          for (int r = 0; r < ROWS; ++r)
            acc[r] = fmaf(xs[r * D + d], w, acc[r]);
        }
      }
      for (int k = 0; k < H; ++k) {
        const float w = wh[(size_t)k * G + j];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) acc[r] = fmaf(hs[r * H + k], w, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) zs[r * G + j] = acc[r];
    }
    __syncthreads();
    // Phase 2: cell update and output; then stage the next step's input.
    if constexpr (HOIST && EMIT) {
      if (s + 1 < lmax)
        load_xz_col(nxt, x, lens, b0, s + 1, T, G, dir, threadIdx.x);
    }
    for (int i = threadIdx.x; i < ROWS * H; i += blockDim.x) {
      const int r = i / H;
      const int k = i - r * H;
      const int L = lens[r];
      if (s < L) {
        const float* z = zs + r * G;
        const float gi = sigmoid_f32(z[k]);
        const float gf = sigmoid_f32(z[H + k]);
        const float go = sigmoid_f32(z[2 * H + k]);
        const float ci = tanhf(z[3 * H + k]);
        const float c = gf * cs[i] + gi * ci;
        const float h = tanhf(c) * go;
        cs[i] = c;
        hs[i] = h;
        const int t = dir == 0 ? s : L - 1 - s;
        y[((size_t)(b0 + r) * T + t) * 2 * H + dir * H + k] = h;
        if (EMIT) {
          const size_t f = ((size_t)(b0 + r) * T + t) * 2 + dir;
          gates[f * G + k] = gi;
          gates[f * G + H + k] = gf;
          gates[f * G + 2 * H + k] = go;
          gates[f * G + 3 * H + k] = ci;
          cell[f * H + k] = c;
        }
      }
    }
    if (!HOIST && s + 1 < lmax) load_x(xs, x, lens, b0, s + 1, T, D, dir);
    __syncthreads();
  }
}

template <bool EMIT, bool HOIST>
int launch(const float* x, const int32_t* lengths, const float* wx,
           const float* wh, const float* b, float* y, float* gates,
           float* cell, int B, int T, int D, int H, void* stream) {
  const size_t smem =
      (size_t)ROWS * ((HOIST ? 0 : D) + 6 * H) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        bidi_lstm_fwd_kernel<EMIT, HOIST>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int threads = ((4 * H + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  const dim3 grid((B + ROWS - 1) / ROWS, 2);
  bidi_lstm_fwd_kernel<EMIT, HOIST>
      <<<grid, threads, smem, (cudaStream_t)stream>>>(
          x, lengths, wx, wh, b, y, gates, cell, B, T, D, H);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success). All
// pointers are device pointers; `lengths` may be NULL. wx, wh, b hold the
// forward direction's weights followed by the reverse direction's:
// wx [2,D,4H], wh [2,H,4H], b [2,4H]. B, T, D, H >= 1.
extern "C" int clstm_bidi_lstm_fwd(const float* x, const int32_t* lengths,
                                   const float* wx, const float* wh,
                                   const float* b, float* y, int B, int T,
                                   int D, int H, void* stream) {
  return launch<false, false>(x, lengths, wx, wh, b, y, nullptr, nullptr, B,
                              T, D, H, stream);
}

// K1: as clstm_bidi_lstm_fwd, and also writes gates [B,T,2,4H] and
// cell [B,T,2,H].
extern "C" int clstm_bidi_lstm_fwd_state(const float* x,
                                         const int32_t* lengths,
                                         const float* wx, const float* wh,
                                         const float* b, float* y,
                                         float* gates, float* cell, int B,
                                         int T, int D, int H, void* stream) {
  return launch<true, false>(x, lengths, wx, wh, b, y, gates, cell, B, T, D,
                             H, stream);
}

// K4, inference: y [B,T,2H] from the hoisted projection xz [B,T,2,4H] and
// wh [2,H,4H]. B, T, H >= 1.
extern "C" int clstm_bidi_lstm_fwd_xz(const float* xz, const int32_t* lengths,
                                      const float* wh, float* y, int B, int T,
                                      int H, void* stream) {
  return launch<false, true>(xz, lengths, nullptr, wh, nullptr, y, nullptr,
                             nullptr, B, T, 0, H, stream);
}

// K4, state mode: as clstm_bidi_lstm_fwd_xz, and also writes gates
// [B,T,2,4H] and cell [B,T,2,H] as K1 does.
extern "C" int clstm_bidi_lstm_fwd_xz_state(const float* xz,
                                            const int32_t* lengths,
                                            const float* wh, float* y,
                                            float* gates, float* cell, int B,
                                            int T, int H, void* stream) {
  return launch<true, true>(xz, lengths, nullptr, wh, nullptr, y, gates,
                            cell, B, T, 0, H, stream);
}
