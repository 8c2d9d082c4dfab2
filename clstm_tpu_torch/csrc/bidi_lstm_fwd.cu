// Bidirectional LSTM forward for sm_90a, in four modes of one kernel
// (template flags EMIT and HOIST; WRES follows the plan, below), each in two
// precisions (template element type E: float, or __nv_bfloat16 for the bf16
// mode), all launched by the C entry clstm_lstm_fwd, whose hoist, emit and
// bf arguments pick the instance:
//
//   K3 (EMIT=false, HOIST=false): replaces the TPU kernel
//   clstm_tpu/ops/pallas_lstm.py::_fwd_kernel with emit_state=False,
//   proj_in=False (bidi_lstm_pallas(..., with_state=False), serving).
//   K1 (EMIT=true, HOIST=false): replaces the same kernel with
//   emit_state=True (the forward of bidi_lstm_pallas's custom VJP,
//   training). It also writes what the backward kernel K2 reads.
//   K4 (HOIST=true, EMIT as for K3 and K1): replaces _fwd_kernel with
//   proj_in=True, which the JAX package takes when D+1 > ceil(H/128)·128
//   (pallas_lstm.py:836; the second layer of the bidi2 net). The input
//   projection was hoisted out of the recurrence into one product (xz,
//   computed before the launch, as _proj_stream is on the TPU); the kernel
//   runs only the h·Wh chain on it.
//
// Same contract as clstm_tpu_torch/ops/lstm.py::bidi_lstm_apply (K3),
// bidi_lstm_fwd_state_plain (K1), bidi_lstm_apply_xz and
// bidi_lstm_fwd_state_xz_plain (K4):
//
//   x [B,T,D] f32, lengths [B] int32 (or NULL: all T), per direction the
//   fused weights Wx [D,4H], Wh [H,4H], b [4H], gate order (gi, gf, go, ci)
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
//   in chain order. Storing the gates spares K2 a second serial [x|1|h]·W
//   product per step.
//
// The weights come interleaved by unit: wh [2][H][H][4] (row k, unit u,
// gate g: Wh[k, g·H + u]) and, without HOIST, wx [2][D+1][H][4] (the rows
// of Wx, then b), so that one float4 holds a unit's four gate columns.
//
// What bounds it. A serial chain of T steps per direction; each step is a
// [rows, D+1+H] x [D+1+H, 4H] product, then the gate math. The earlier
// design (one block of 4 rows per SM, a thread per gate column) read the
// weights from L2 at every step, each load feeding 4 FMAs: ~6 TB/s of L2
// reads at H=200 and a step of 15-17 us, where its FMAs take ~3-4 us per
// SM. Now the weights stay in shared memory and the step is bound by the
// issue of its FMAs and shared loads on a few warps per SM, and by the
// cluster barrier that hands h on (PERF.md §6).
//
// Design: weights resident in shared memory across a thread-block cluster.
//   - One direction's chain for a group of R rows runs on a cluster of C
//     CTAs, one per SM. CTA c owns U consecutive units with all four of
//     their gate columns, so its gate math, c and stores stay local. It
//     loads its slice of Wh [H, 4U] (and [Wx; b] [D+1, 4U]) into shared
//     memory once, before the chain: each weight read there then feeds R
//     rows. The FMA work per SM and step is R·(D+1+H)·4U, the same as 4
//     rows of all 4H columns when R = 4C.
//   - Register tiles: a tile is one unit's 4 gates for 4 rows; h is read
//     as a float4 across rows and the weights as a float4 across gates, so
//     two shared loads feed 16 FMAs. Two threads share a tile, the two
//     halves of a warp: each sums half of the k (and d) range, the halves
//     meet by one shuffle, and each then does the gate math and stores of
//     two of the rows. That doubles the warps per SM, which the step's
//     latency needs (one tile per thread left most schedulers one warp,
//     stalled on every shared load). Sums run in a fixed order: two calls
//     give bitwise equal results.
//   - h of every row must reach every CTA at every step: each thread writes
//     its new h into the h buffer of every CTA of the cluster through
//     distributed shared memory (mapa + st.shared::cluster). The buffer is
//     double-buffered by step parity, so one cluster barrier per step
//     suffices. It is split (barrier.cluster.arrive.release / wait.acquire)
//     and the rest of the step runs between the two: the y, gates and cell
//     stores (after the arrive, so that its release does not wait for
//     them; where they sit decides what they cost), then the next step's
//     input work: x_{s+1}·[Wx; b] for the tile (K1, K3; x staged into a
//     three-slot ring by cp.async two steps ahead) or the loads of the next
//     step's xz into registers (K4), added after the h·Wh product so that
//     their latency hides behind it.
//   - The plan (C, R, U, which weights are resident: WRES) is chosen on
//     the host (ops/bidi_lstm_kernel.py::fwd_plan): the smallest C in {1,
//     2, 4, 8} whose slice fits (WRES 1), or, where [Wx; b] is at most a
//     quarter of Wh, whose Wh slice fits with [Wx; b] read from L2 (WRES
//     2: bidi2's first layer); R so that the clusters fill the card in one
//     wave (clstm_lstm_fwd_clusters asks
//     cudaOccupancyMaxActiveClusters). Where no C holds the slice (H of
//     several hundred with a wide input, H = 700, 2048), the same kernel
//     reads it from L2 (WRES 0): R rows still share each weight load.
//
// The bf16 mode (E = __nv_bfloat16) is the JAX package's production mode,
// bidi_lstm_pallas(..., xz_bf16=True): x (or xz, the rounded hoisted
// product), the weights [Wx; b] and Wh, y and cell are bf16; every product
// accumulates in f32 (each bf16 value is converted to f32 at its FMA, so
// each product is exact), the projection inside the kernel is not rounded,
// and the gate math and the h and c carries stay f32. h is rounded to bf16
// where it enters the recurrent product (the h buffer holds the rounded
// values, in f32) and where it is stored as y. The gates are stored in f32
// in both modes: the JAX package recomputes them in f32 in its backward,
// and bf16 gates moved the gradients ~1e-2 of their max away from it
// (tests/test_torch_bf16.py). The weights take half the shared memory, so a
// plan may keep more resident at a smaller C. x is staged into the ring in
// pairs of columns ([D/2][R][2] bf16, D even: the wrapper pads an odd D),
// so that 4-byte cp.async copies stage it and one 16-byte load gives a
// tile's 4 rows at 2 columns.
//
//   Tried and not kept (slower in turns on the card): handing h on by
//   st.async with an mbarrier per slot instead of the cluster barrier;
//   loading the operands of the next k pair by hand ahead of the FMAs;
//   sigmoid and tanh through e^-|v| with every divisor in (1, 2]; tiles
//   ordered row group first (lanes share weight loads, but the stores and
//   xz loads scatter); tiles of 8 rows.
//
// In the bf16 mode, all four (K3, K1, K4 in both modes) run on a second
// kernel where ops/bidi_lstm_kernel.py::fwd16_plan gives it a plan
// (fwd16_kernel, below; the C entry clstm_lstm_fwd16): z on the
// bf16 tensor cores (mma.sync), the gate math on the accumulator
// fragments, h all-gathered across the cluster in 16-byte chunks; its
// EMIT=false instances (K3, K4 inference: the serving path) keep no gates
// or cell stage and store y alone. The kernel above keeps the f32 mode
// and the shapes fwd16_plan leaves to it (no plan fits: H = 700, 2048; or
// short chains, where it was the faster on the card).

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int RT = 4;             // rows of a register tile
constexpr int RH = RT / 2;        // rows of each half of a tile
constexpr int FWD_THREADS = 512;  // most threads a CTA may have
constexpr int SMEM_MAX = 232448;  // dynamic shared memory a CTA may use

// 1 / (1 + e^-v), with e^-v held below 2^116: where v < -80 the divisor
// would otherwise overflow or leave the range of the division's fast path,
// and the slow path costs every thread of the warp (saturated gates of a
// trained net). Below -80 the result, < 2e-35, is that of -80.
__device__ __forceinline__ float sigmoid_f32(float v) {
  return 1.0f / (1.0f + expf(fminf(-v, 80.0f)));
}

// v into CTA `rank`'s copy of `local` (2 floats, 8-byte aligned).
__device__ __forceinline__ void st_cluster2(const float* local, uint32_t rank,
                                            float2 v) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_addr(local)), "r"(rank));
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n" ::"r"(remote),
               "f"(v.x), "f"(v.y)
               : "memory");
}

// acc[i][g] += a[i] · w[g] for the 4 rows i and 4 gates g.
__device__ __forceinline__ void fma16(float (&acc)[RT][4], float4 a,
                                      float4 w) {
  const float av[RT] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    acc[i][0] = fmaf(av[i], w.x, acc[i][0]);
    acc[i][1] = fmaf(av[i], w.y, acc[i][1]);
    acc[i][2] = fmaf(av[i], w.z, acc[i][2]);
    acc[i][3] = fmaf(av[i], w.w, acc[i][3]);
  }
}

// acc += Σ_{j<n} a_j ⊗ w_j for j ascending, a_j = the float4 at a + j·as
// (4 rows), w_j at w + j·ws (4 gates). Unrolled deeper for [Wx; b] read
// from L2, so that more of its loads are in flight.
template <bool W_L2, class EW>
__device__ __forceinline__ void dot_rows(float (&acc)[RT][4],
                                         const float* a, size_t as,
                                         const EW* w, size_t ws, int n) {
  if constexpr (W_L2) {
#pragma unroll 8
    for (int j = 0; j < n; ++j) fma16(acc, ld4(a + j * as), ld4(w + j * ws));
  } else {
#pragma unroll 4
    for (int j = 0; j < n; ++j) fma16(acc, ld4(a + j * as), ld4(w + j * ws));
  }
}

// The bf16 x ring's version of dot_rows over the x part: a points at column
// pair j0 of the ring [D/2][R][2] at the tile's first row, as = 2R; pair j
// holds the tile's 4 rows at columns 2j and 2j+1 in 16 bytes. Columns
// ascending, as dot_rows.
template <bool W_L2>
__device__ __forceinline__ void dot_rows_x2(float (&acc)[RT][4],
                                            const bf16* a, size_t as,
                                            const bf16* w, size_t ws, int n) {
  auto step = [&](int j) {
    const uint4 v = *reinterpret_cast<const uint4*>(a + j * as);
    fma16(acc, make_float4(lo_f(v.x), lo_f(v.y), lo_f(v.z), lo_f(v.w)),
          ld4(w + 2 * j * ws));
    fma16(acc, make_float4(hi_f(v.x), hi_f(v.y), hi_f(v.z), hi_f(v.w)),
          ld4(w + (2 * j + 1) * ws));
  };
  if constexpr (W_L2) {
#pragma unroll 4
    for (int j = 0; j < n; ++j) step(j);
  } else {
#pragma unroll 2
    for (int j = 0; j < n; ++j) step(j);
  }
}

// acc[i][g] += acc of lane ^ 16 (the tile's other half of the sum). Both
// halves get the same bits: a + b == b + a in IEEE arithmetic.
__device__ __forceinline__ void sum_halves(float (&acc)[RT][4]) {
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int g = 0; g < 4; ++g)
      acc[i][g] += __shfl_xor_sync(0xffffffffu, acc[i][g], 16);
}

// Bytes of the resident weights [H (+ D+1 where wres is 1)][U][4] of es
// bytes each (4 f32, 2 bf16), rounded up to 16.
__host__ __device__ inline size_t weight_bytes(int D, int H, int U,
                                               bool hoist, int wres, int es) {
  const size_t n =
      wres == 0 ? 0
                : (size_t)(H + (hoist || wres == 2 ? 0 : D + 1)) * 4 * U;
  return (n * es + 15) / 16 * 16;
}

// Bytes of dynamic shared memory: the resident weights, h [2][H][R] (f32),
// the x ring [3][D][R] of es bytes (without HOIST) and the R lengths.
// ops/bidi_lstm_kernel.py::fwd_smem computes the same.
size_t smem_bytes(int D, int H, int R, int U, bool hoist, int wres, int es) {
  return weight_bytes(D, H, U, hoist, wres, es) + 4 * 2 * (size_t)H * R +
         (hoist ? 0 : (size_t)es * 3 * R * D) + 4 * (size_t)R;
}

// Two threads per tile (a unit's 4 gates for 4 rows), in the two halves of
// a warp.
int fwd_threads(int R, int U) {
  const int tiles = U * (R / RT);
  return (tiles + 15) / 16 * 32;
}

// x is xz [B,T,2,4H] when HOIST (wx unused), else x [B,T,D]; E the element
// type of x, the weights, y and cell (the gates are f32 in both modes).
template <bool EMIT, bool HOIST, int WRES, class E>
__global__ void __launch_bounds__(FWD_THREADS)
    bidi_lstm_fwd_kernel(const E* __restrict__ x,
                         const int32_t* __restrict__ lengths,
                         const E* __restrict__ wx, const E* __restrict__ wh,
                         E* __restrict__ y, float* __restrict__ gates,
                         E* __restrict__ cell, int B, int T, int D, int H,
                         int R, int U, int dm) {
  constexpr bool BF = sizeof(E) == 2;
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = (int)cluster_size();
  const int crank = (int)cluster_rank();
  // The directions of the call (dm, dirs_of): nd in the streams, this
  // CTA's at place `dsl` of them, running forward (dir 0) or reversed.
  const int nd = dm ? 1 : 2;
  const int dsl = dm ? 0 : (int)blockIdx.y;
  const int dir = dm ? dm - 1 : (int)blockIdx.y;
  const int b0 = (blockIdx.x / C) * R;
  const int k0 = crank * U;
  const int nu = max(0, min(U, H - k0));  // units this CTA owns
  const int G = 4 * H;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int KX = HOIST ? 0 : D + 1;
  // Resident: WRES 1 the whole slice, 2 Wh's only ([Wx; b] from L2).
  constexpr bool WHS = WRES != 0, WXS = WRES == 1 && !HOIST;
  E* whs = reinterpret_cast<E*>(smem);                       // [H][U][4]
  E* wxs = whs + (WHS ? (size_t)H * 4 * U : 0);              // [D+1][U][4]
  float* hbuf = reinterpret_cast<float*>(
      smem + weight_bytes(D, H, U, HOIST, WRES, (int)sizeof(E)));  // [2][H][R]
  // The x ring, [3][D][R] (f32) or [3][D/2][R][2] (bf16).
  E* xs = reinterpret_cast<E*>(hbuf + 2 * (size_t)H * R);
  int* lens = reinterpret_cast<int*>(xs + (HOIST ? 0 : 3 * (size_t)R * D));
  wh += (size_t)dsl * H * G;
  if (!HOIST) wx += (size_t)dsl * KX * G;

  // The thread's tile: unit k0 + ul, rows rb .. rb+3 of the group. Two
  // threads share it, the two halves of a warp (lanes l and l ^ 16): half
  // hf sums k in [j0, j1) and d in [d0, d1) (bf16: column pairs [d0, d1)),
  // the halves' sums meet by one shuffle, and each half then takes two of
  // the rows, r0 and r0 + 1, for the gate math, the state and the stores.
  const int lane = tid & 31, hf = lane >> 4;
  const int tile = (tid >> 5) * 16 + (lane & 15);
  const int ul = tile % U, rb = (tile / U) * RT;
  const bool comp = tile < U * (R / RT) && ul < nu;
  const int k = k0 + ul;
  const int hh = (H + 1) / 2, j0 = hf ? hh : 0, j1 = hf ? H : hh;
  const int DN = BF ? D / 2 : D;  // columns (bf16: pairs) of x
  const int dh = (DN + 1) / 2, d0 = hf ? dh : 0, d1 = hf ? DN : dh;
  const int r0 = rb + RH * hf;

  for (int r = tid; r < R; r += nt) {
    const int b = b0 + r;
    int L = 0;
    if (b < B) L = lengths ? lengths[b] : T;
    lens[r] = min(max(L, 0), T);
  }
  __syncthreads();
  int lmax = 0;
  for (int r = 0; r < R; ++r) lmax = max(lmax, lens[r]);
  int L[RH];
#pragma unroll
  for (int i = 0; i < RH; ++i) L[i] = comp ? lens[r0 + i] : 0;

  // The CTA's weight slice: row j of it is 4·nu contiguous elements, a
  // unit's 4 gates in 16 (f32) or 8 (bf16) bytes.
  auto copy_unit = [&](E* dst, const E* src) {
    if constexpr (BF)
      cp_async8(dst, src);
    else
      cp_async16(dst, src);
  };
  if (WHS) {
    for (int i = tid; i < H * nu; i += nt) {
      const int j = i / nu, u = i - j * nu;
      copy_unit(whs + ((size_t)j * U + u) * 4,
                wh + ((size_t)j * H + k0 + u) * 4);
    }
    if (WXS)
      for (int i = tid; i < KX * nu; i += nt) {
        const int j = i / nu, u = i - j * nu;
        copy_unit(wxs + ((size_t)j * U + u) * 4,
                  wx + ((size_t)j * H + k0 + u) * 4);
      }
  }
  // x of chain step s for the R rows into ring slot s % 3, as [D][R]
  // (f32, 4 bytes a copy) or [D/2][R][2] (bf16, a column pair a copy).
  auto stage_x = [&](int s) {
    E* dst = xs + (size_t)(s % 3) * D * R;
    for (int i = tid; i < R * DN; i += nt) {
      const int r = i / DN, d = i - r * DN;
      const int Lr = lens[r];
      const bool valid = s < Lr;
      const int t = dir == 0 ? s : Lr - 1 - s;
      const E* src = x + ((size_t)(b0 + r) * T + t) * D + (BF ? 2 * d : d);
      cp_async4z(dst + (BF ? ((size_t)d * R + r) * 2 : (size_t)d * R + r),
                 valid ? src : x, valid);
    }
  };
  if (!HOIST) {
    if (lmax > 0) stage_x(0);
    if (lmax > 1) stage_x(1);
  }
  cp_async_commit();
  for (int i = tid; i < H * R; i += nt) hbuf[i] = 0.0f;  // h_0, slot 0

  // Frames t >= len are padding in both halves: exact zeros (this CTA's
  // units).
  for (int r = 0; r < R && b0 + r < B; ++r) {
    const int Lr = lens[r];
    for (int i = tid; i < (T - Lr) * nu; i += nt) {
      const int t = Lr + i / nu;
      const int kk = k0 + i % nu;
      y[((size_t)(b0 + r) * T + t) * nd * H + dsl * H + kk] = from_f<E>(0.0f);
      if (EMIT) {
        const size_t f = ((size_t)(b0 + r) * T + t) * nd + dsl;
        cell[f * H + kk] = from_f<E>(0.0f);
        for (int g = 0; g < 4; ++g) gates[f * G + g * H + kk] = 0.0f;
      }
    }
  }
  cp_async_wait<0>();
  // Every CTA of the cluster has started and initialised its buffers
  // before any h crosses to it.
  cluster_arrive();
  cluster_wait();

  const size_t whstride = WHS ? 4 * (size_t)U : 4 * (size_t)H;
  const size_t wxstride = WXS ? 4 * (size_t)U : 4 * (size_t)H;
  const E* whk = WHS ? whs + 4 * ul : wh + 4 * (size_t)k;
  const E* wxk = HOIST ? nullptr : (WXS ? wxs + 4 * ul : wx + 4 * (size_t)k);

  float acc[RT][4], c[RH], h[RH], gt[RH][4];
  [[maybe_unused]] float nxt[RH][4];
#pragma unroll
  for (int i = 0; i < RT; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;
#pragma unroll
  for (int i = 0; i < RH; ++i) c[i] = h[i] = 0.0f;

  // acc = the half's share of [x_s | 1]·[Wx; b] for the tile (K1, K3):
  // the bias in half 0, columns (bf16: column pairs) in [d0, d1).
  auto x_part = [&](int s) {
    const float4 bv = hf ? make_float4(0.0f, 0.0f, 0.0f, 0.0f)
                         : ld4(wxk + (size_t)D * wxstride);
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      acc[i][0] = bv.x;
      acc[i][1] = bv.y;
      acc[i][2] = bv.z;
      acc[i][3] = bv.w;
    }
    if constexpr (BF) {
      const E* xr = xs + (size_t)(s % 3) * D * R + 2 * rb;
      dot_rows_x2<!WXS>(acc, xr + (size_t)d0 * 2 * R, 2 * (size_t)R,
                        wxk + 2 * (size_t)d0 * wxstride, wxstride, d1 - d0);
    } else {
      const float* xr = reinterpret_cast<const float*>(xs) +
                        (size_t)(s % 3) * D * R + rb;
      dot_rows<!WXS>(acc, xr + (size_t)d0 * R, R,
                     wxk + (size_t)d0 * wxstride, wxstride, d1 - d0);
    }
  };
  // xz of chain step s for the thread's unit and rows (K4).
  auto load_xz = [&](int s) {
#pragma unroll
    for (int i = 0; i < RH; ++i) {
      nxt[i][0] = nxt[i][1] = nxt[i][2] = nxt[i][3] = 0.0f;
      if (s < L[i]) {
        const int t = dir == 0 ? s : L[i] - 1 - s;
        const E* src =
            x + (((size_t)(b0 + r0 + i) * T + t) * nd + dsl) * G + k;
#pragma unroll
        for (int g = 0; g < 4; ++g)
          nxt[i][g] = to_f(__ldg(src + (size_t)g * H));
      }
    }
  };

  if (comp && lmax > 0) {
    if constexpr (HOIST)
      load_xz(0);
    else
      x_part(0);
  }
  for (int s = 0; s < lmax; ++s) {
    if (s > 0) cluster_wait();  // h_s and x_{s+1} are in place
    if (!HOIST && s + 2 < lmax) stage_x(s + 2);
    cp_async_commit();
    if (comp) {
      if constexpr (HOIST) {
#pragma unroll
        for (int i = 0; i < RT; ++i)
          acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;
      }
      const float* hs = hbuf + (size_t)(s & 1) * H * R + rb;
      dot_rows<false>(acc, hs + (size_t)j0 * R, R,
                      whk + (size_t)j0 * whstride, whstride, j1 - j0);
    }
    sum_halves(acc);  // warp-uniform: every lane takes part
    if (comp) {
      // The gate math of the half's rows without branches, so that their
      // transcendentals interleave; a row whose chain has ended keeps its
      // state.
#pragma unroll
      for (int i = 0; i < RH; ++i) {
        float z[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          z[g] = hf ? acc[RH + i][g] : acc[i][g];
          if constexpr (HOIST) z[g] += nxt[i][g];
        }
        gt[i][0] = sigmoid_f32(z[0]);
        gt[i][1] = sigmoid_f32(z[1]);
        gt[i][2] = sigmoid_f32(z[2]);
        gt[i][3] = tanhf(z[3]);
        const float cn = gt[i][1] * c[i] + gt[i][0] * gt[i][3];
        const float hn = tanhf(cn) * gt[i][2];
        const bool on = s < L[i];
        c[i] = on ? cn : c[i];
        h[i] = on ? hn : h[i];
      }
      if (s + 1 < lmax) {
        // h as the next product's operand (rounded to bf16 in that mode).
        float* dst = hbuf + (size_t)((s + 1) & 1) * H * R +
                     (size_t)k * R + r0;
        const float2 hv = make_float2(operand<E>(h[0]), operand<E>(h[1]));
        for (int q = 0; q < C; ++q) st_cluster2(dst, (uint32_t)q, hv);
      }
    }
    if (s + 1 < lmax) {
      cp_async_wait<0>();
      cluster_arrive();
    }
    // While the other CTAs reach the barrier: the outputs (stored after
    // the arrive, whose release would otherwise wait for them), then the
    // next step's input work.
    if (comp) {
#pragma unroll
      for (int i = 0; i < RH; ++i) {
        if (s < L[i]) {
          const int b = b0 + r0 + i;
          const int t = dir == 0 ? s : L[i] - 1 - s;
          y[((size_t)b * T + t) * nd * H + dsl * H + k] = from_f<E>(h[i]);
          if (EMIT) {
            const size_t f = ((size_t)b * T + t) * nd + dsl;
#pragma unroll
            for (int g = 0; g < 4; ++g) gates[f * G + g * H + k] = gt[i][g];
            cell[f * H + k] = from_f<E>(c[i]);
          }
        }
      }
      if (s + 1 < lmax) {
        if constexpr (HOIST)
          load_xz(s + 1);
        else
          x_part(s + 1);
      }
    }
  }
  // No CTA leaves while another may still address its shared memory.
  cluster_arrive();
  cluster_wait();
}

struct Plan {
  int C, R, U;
  int wres;
  int threads;
  size_t smem;
};

// The plan the caller passed, checked: C in {1, 2, 4, 8} with every CTA
// owning at least one unit and all of them together every unit, R a
// positive multiple of 4, wres 0 (weights from L2),
// 1 (resident) or 2 (Wh resident, [Wx; b] from L2), the threads and shared
// memory within a CTA's; es the element size (2: bf16, D even).
bool make_plan(Plan& p, int D, int H, bool hoist, int C, int R, int U,
               int wres, int es) {
  if (!(C == 1 || C == 2 || C == 4 || C == 8) || R < RT || R % RT != 0 ||
      U < 1 || (long long)C * U < H ||
      (long long)(C - 1) * U >= H || wres < 0 || wres > 2 ||
      (es == 2 && !hoist && D % 2 != 0))
    return false;
  p.C = C;
  p.R = R;
  p.U = U;
  p.wres = wres;
  p.threads = fwd_threads(R, U);
  p.smem = smem_bytes(D, H, R, U, hoist, wres, es);
  return p.threads <= FWD_THREADS && p.smem <= (size_t)SMEM_MAX;
}

// A launch configuration of the plan: grid (C · row groups, the call's
// directions), clusters of C CTAs along x.
struct Config {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  Config(const Plan& p, unsigned gridx, cudaStream_t st, int dm = 0)
      : cfg() {
    cfg.gridDim = dim3(gridx, (unsigned)dirs_of(dm), 1);
    cfg.blockDim = dim3((unsigned)p.threads, 1, 1);
    cfg.dynamicSmemBytes = p.smem;
    cfg.stream = st;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)p.C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

template <class E>
using Kernel = void (*)(const E*, const int32_t*, const E*, const E*, E*,
                        float*, E*, int, int, int, int, int, int, int);

// The kernel instance of the plan, with its shared-memory limit set.
template <bool EMIT, bool HOIST, class E>
cudaError_t kernel_of(const Plan& p, Kernel<E>* kern) {
  static const Kernel<E> table[3] = {bidi_lstm_fwd_kernel<EMIT, HOIST, 0, E>,
                                     bidi_lstm_fwd_kernel<EMIT, HOIST, 1, E>,
                                     bidi_lstm_fwd_kernel<EMIT, HOIST, 2, E>};
  *kern = table[p.wres];
  return cudaFuncSetAttribute(*kern,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)p.smem);
}

template <bool EMIT, bool HOIST, class E>
int launch(const E* x, const int32_t* lengths, const E* wx, const E* wh, E* y,
           float* gates, E* cell, int B, int T, int D, int H, int C, int R,
           int U, int wres, int dm, void* stream) {
  Plan p;
  if (B < 1 || T < 1 || H < 1 || (!HOIST && D < 1) || dm < 0 || dm > 2 ||
      !make_plan(p, D, H, HOIST, C, R, U, wres, (int)sizeof(E)))
    return (int)cudaErrorInvalidValue;
  Kernel<E> kern;
  cudaError_t e = kernel_of<EMIT, HOIST, E>(p, &kern);
  if (e != cudaSuccess) return (int)e;
  Config c(p, (unsigned)(p.C * ((B + p.R - 1) / p.R)), (cudaStream_t)stream,
           dm);
  e = cudaLaunchKernelEx(&c.cfg, kern, x, lengths, wx, wh, y, gates, cell, B,
                         T, D, H, p.R, p.U, dm);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <bool EMIT, bool HOIST, class E>
int active_clusters(const Plan& p) {
  Kernel<E> kern;
  cudaError_t e = kernel_of<EMIT, HOIST, E>(p, &kern);
  if (e != cudaSuccess) return -(int)e;
  Config c(p, (unsigned)p.C, nullptr);
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, kern, &c.cfg);
  return e == cudaSuccess ? n : -(int)e;
}

template <class E>
long long plan_smem(int D, int H, int hoist, int C, int R, int U, int wres) {
  Plan p;
  return make_plan(p, D, H, hoist != 0, C, R, U, wres, (int)sizeof(E))
             ? (long long)p.smem
             : 0;
}

template <class E>
int plan_clusters(int D, int H, int hoist, int emit, int C, int R, int U,
                  int wres) {
  Plan p;
  if (!make_plan(p, D, H, hoist != 0, C, R, U, wres, (int)sizeof(E)))
    return -(int)cudaErrorInvalidValue;
  if (hoist)
    return emit ? active_clusters<true, true, E>(p)
                : active_clusters<false, true, E>(p);
  return emit ? active_clusters<true, false, E>(p)
              : active_clusters<false, false, E>(p);
}

// ---------------------------------------------------------------------------
// The bf16 recurrence on the tensor cores (fwd16): K3, K1 and K4 (both modes)
// ---------------------------------------------------------------------------

// Rows of an m16 tile, threads of a CTA (20 warps), the multiple of units
// a CTA owns (its h goes to its peers in 16-byte chunks of 8 units).
constexpr int F16_M = 16;
constexpr int F16_THREADS = 640;
constexpr int F16_WARPS = F16_THREADS / 32;
constexpr int F16_UNITS = 8;
// Dynamic shared memory a CTA may use, less the static row lengths.
constexpr int F16_SMEM_MAX = SMEM_MAX - 4 * 2 * F16_M;
// The non-portable cluster size an H100 allows: H = 512's Wh and [Wx; b]
// resident at 32 units a CTA, where no portable size holds a slice (the
// host tries it only then: ops/bidi_lstm_kernel.py::fwd16_cluster_plan).
constexpr int F16_WIDE_C = 16;

// n tiles a warp takes at most: 2 with one m tile, 1 with two. 20 warps
// of 2 n tiles hold the 36 of H=200 at C=3 (4 warps of 3 and 12 of 2 at
// 512 threads, which left the 4 the critical path and spilled registers:
// 20 warps were faster in turns, PERF.md §6).
__host__ __device__ constexpr int f16_ng(int mt) { return mt == 1 ? 2 : 1; }

// Where a CTA's operands live in its shared memory
// (ops/bidi_lstm_kernel.py::fwd16_geometry counts the same): Bw its
// columns of Wh and of [Wx; b] [N = 4U][KH + KX + 8] (row 4·u + g: gate g
// of its unit u; k contiguous, Wh's KH = H up to 16 first, then [Wx; b]'s
// KX = D+1 up to 16, none with HOIST), Ah the h operand [2 parities][R][KH
// + 8], Ax the x ring [3 slots][R][KX + 8] (not with HOIST) or the xz ring
// [3 slots][R][4][U] (HOIST), all bf16; the output stage of each parity:
// gs the gates [2][R][4U + 2] f32 (gate g of unit u at g·U + u; rows 4U +
// 2 words apart, so that the 16 rows a warp writes at once fall in 16 bank
// pairs; with emit only), hs h (as y and as the next operand) and cs c
// [2][R][U] bf16 (with emit only).
// Rows of the operands are K + 8 elements apart: an odd multiple of 16
// bytes, so the 8 rows an ldmatrix reads fall in 8 bank groups.
struct Geo16 {
  int N, KH, KX, ldb, ldh, ldx;
  long long off_ah, off_ax, off_gs, off_hs, off_cs, bytes;
};

__host__ __device__ inline Geo16 geo16(int D, int H, int U, int R,
                                       bool hoist, bool emit) {
  Geo16 g;
  g.N = 4 * U;
  g.KH = up_to(H, 16);
  g.KX = hoist ? 0 : up_to(D + 1, 16);
  g.ldb = g.KH + g.KX + 8;
  g.ldh = g.KH + 8;
  g.ldx = g.KX + 8;
  g.off_ah = (long long)g.N * g.ldb * 2;
  g.off_ax = g.off_ah + 2LL * R * g.ldh * 2;
  g.off_gs = g.off_ax + (hoist ? 3LL * R * 4 * U * 2 : 3LL * R * g.ldx * 2);
  g.off_hs = g.off_gs + (emit ? 2LL * R * (4 * U + 2) * 4 : 0);
  g.off_cs = g.off_hs + 2LL * R * U * 2;
  g.bytes = g.off_cs + (emit ? 2LL * R * U * 2 : 0);
  return g;
}

// A fwd16 plan, checked: C in {1, 2, 3, 4, 8} (the portable sizes) or
// F16_WIDE_C, with every CTA owning at least one unit and all of them
// together every unit, R 16 or 32 rows, U a multiple of F16_UNITS whose n
// tiles (U/2) the warps take at most f16_ng a warp, D even (the kernel's x
// width; 0 with hoist), shared memory within a CTA's. Returns its bytes of
// shared memory, 0 if it is not one.
long long plan16(int D, int H, bool hoist, bool emit, int C, int R, int U) {
  if (!((C >= 1 && C <= 4) || C == 8 || C == F16_WIDE_C) ||
      !(R == 16 || R == 32) || H < 1 ||
      U < F16_UNITS || U % F16_UNITS != 0 || (long long)C * U < H ||
      (long long)(C - 1) * U >= H ||
      U / 2 > F16_WARPS * f16_ng(R / F16_M) ||
      (!hoist && (D < 2 || D % 2 != 0)))
    return 0;
  const Geo16 g = geo16(D, H, U, R, hoist, emit);
  return g.bytes <= F16_SMEM_MAX ? g.bytes : 0;
}

// c = a·b, m16n8k16, bf16 operands, f32 result (a fresh accumulator).
__device__ __forceinline__ void mma_bf16_0(float (&c)[4],
                                           const uint32_t (&a)[4],
                                           uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.0f));
}

// acc[i][m] += A[m-th 16 rows][k tile kt] · B[n tile jt[i]][k tile kt]ᵀ
// for the k tiles kt < KT in order, for i < ni: A [MT·16][lda] and B
// [N][ldb] bf16 in shared memory, k contiguous. Each tile's product starts
// from a zero accumulator and is added to acc by an f32 add (rounded to
// nearest): the tensor cores add a tile's exact products to their
// accumulator by truncation, so summing every k tile there would move z
// toward zero by up to an ulp a tile; and the MMAs are independent. The
// fragments of a pair of k tiles are loaded before their MMAs (asm
// volatile keeps the order as written, so a load placed after an MMA would
// wait for it); one ldmatrix.x4 gives an n tile's B fragments of both
// tiles of the pair, and each A fragment serves the warp's ni n tiles. acc[i][m][0..1]: row lane/4 of the m tile,
// columns 2(lane%4) and +1 of the n tile; [2..3]: row lane/4 + 8.
template <int MT, int NG>
__device__ __forceinline__ void f16_product(const bf16* A, int lda,
                                            const bf16* Bm, int ldb,
                                            const int (&jt)[NG], int ni,
                                            int KT,
                                            float (&acc)[NG][MT][4]) {
  const int lane = threadIdx.x & 31;
  const uint32_t a0 = smem_addr(A + (lane & 15) * lda + (lane >> 4) * 8);
  uint32_t b0[NG];
#pragma unroll
  for (int i = 0; i < NG; ++i)
    b0[i] = smem_addr(Bm + (jt[i] * 8 + (lane & 7)) * ldb + (lane >> 3) * 8);
  const uint32_t mstep = 2 * F16_M * lda;
  auto add = [&](int i, int m, const float (&d)[4]) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][m][e] += d[e];
  };
  int kt = 0;
  for (; kt + 2 <= KT; kt += 2) {
    uint32_t a[2][MT][4], b[NG][4];
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int m = 0; m < MT; ++m)
        ldsm_x4(a0 + m * mstep + 32 * (kt + p), a[p][m]);
#pragma unroll
    for (int i = 0; i < NG; ++i)
      if (i < ni) ldsm_x4(b0[i] + 32 * kt, b[i]);
    float d[2][NG][MT][4];
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int i = 0; i < NG; ++i)
        if (i < ni)
#pragma unroll
          for (int m = 0; m < MT; ++m)
            mma_bf16_0(d[p][i][m], a[p][m], b[i][2 * p], b[i][2 * p + 1]);
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int i = 0; i < NG; ++i)
        if (i < ni)
#pragma unroll
          for (int m = 0; m < MT; ++m) add(i, m, d[p][i][m]);
  }
  if (kt < KT) {
    uint32_t a[MT][4], b[NG][2];
#pragma unroll
    for (int m = 0; m < MT; ++m) ldsm_x4(a0 + m * mstep + 32 * kt, a[m]);
#pragma unroll
    for (int i = 0; i < NG; ++i)
      if (i < ni) ldsm_x2(b0[i] + 32 * kt, b[i]);
#pragma unroll
    for (int i = 0; i < NG; ++i)
      if (i < ni)
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          float d[4];
          mma_bf16_0(d, a[m], b[i][0], b[i][1]);
          add(i, m, d);
        }
  }
}

// Cycle counts of a step's spans, summed by thread 0 of each CTA, in a
// build with CLSTM_FWD16_PHASES (scripts/torch_fwd16_probe.py --phases):
// the cluster barrier's wait, the x (K1) or xz (K4) staging, the product,
// the gate math with its writes to the output stage, the block barrier,
// the hand-off's copy, the arrive, the next step's input and the stores
// from the stage. No code otherwise.
#ifdef CLSTM_FWD16_PHASES
constexpr int F16_SPANS = 9;
__device__ unsigned long long g_f16_phase[2 * 2048 * F16_SPANS];
#define F16_MARK(i)                              \
  if (tid == 0) {                                \
    const unsigned long long tn_ = clock64();    \
    pd_[i] += tn_ - tq_;                         \
    tq_ = tn_;                                   \
  }
#else
#define F16_MARK(i)
#endif

// A thread's share of a [rows][cols] loop that every step repeats: column
// c0 (then c0 + dc, ...) at rows r0, r0 + dr, ..., so that a step's loop
// needs no division where cols <= the threads (the thread's column is
// decoded once, before the chain).
struct Cols {
  int c0, dc, r0, dr;
};

__device__ __forceinline__ Cols cols_of(int cols, int rows, int tid,
                                        int nt) {
  Cols k;
  if (cols <= nt) {
    k.dr = min(rows, nt / cols);
    k.c0 = tid % cols;
    k.r0 = tid / cols;
    k.dc = cols;
    if (k.r0 >= k.dr) k.c0 = cols;  // no share
  } else {
    k.c0 = tid;
    k.dc = nt;
    k.r0 = 0;
    k.dr = 1;
  }
  return k;
}

// One direction's chain for a group of R = 16·MT rows on a cluster of C
// CTAs (grid: C · row groups along x, 2 directions along y), each step's z
// on bf16 mma.sync (PERF.md §6):
//   - CTA c owns units [c·U, c·U + nu) with their four gate columns and
//     keeps its columns of Wh (and of [Wx; b], K1) in shared memory, as the
//     B operand [4U][K], for the whole chain.
//   - Warp w takes the n tiles w, w + 16, ... of its columns (a tile: two
//     units' four gates, interleaved by unit). K1's [x_s | 1]·[Wx; b] runs
//     on the tensor cores too (exact products, f32 sums: the JAX package's
//     unrounded in-kernel projection), into the accumulators the h·Wh
//     product then adds to; K4 adds xz_s, staged into shared memory by
//     cp.async two steps ahead, to the product's sum at the gates.
//   - The gate math from the accumulator fragments: lanes q and q ^ 1 of a
//     quad hold gates 0-1 and 2-3 of one unit for rows lane/4 and lane/4 +
//     8; one exchange gives the even lane all four gates of the first row,
//     the odd lane those of the second. c, h and the "a row whose chain
//     ended keeps its state" rule stay in registers, in f32.
//   - The step's gates, h (rounded to bf16, as y and as the next product's
//     operand) and c go to an output stage in shared memory, one per
//     parity. h is all-gathered from it into every peer's h operand of the
//     next parity in 16-byte chunks (st.shared::cluster.v4), with one split
//     cluster barrier a step; between its arrive and its wait the CTA
//     does the next step's input work, then writes the stage out to y,
//     gates and cell, whole runs of units per row and gate (stored straight
//     from the fragments, a warp's stores scatter over 16 rows, 8 bytes
//     each, and took much of the step).
//   - EMIT=false (K3, K4 inference: the JAX package's emit_state=False,
//     serving): the same chain and the same sums, roundings and gate math;
//     no gates or cell are written (gates and cell may be NULL), so the
//     CTA keeps no gates or cell stage (geo16 counts only the h stage),
//     and the stores from the stage are y's alone.
template <bool HOIST, bool EMIT, int MT>
__global__ void __launch_bounds__(F16_THREADS, 1)
    fwd16_kernel(const bf16* __restrict__ x,
                 const int32_t* __restrict__ lengths,
                 const bf16* __restrict__ wx, const bf16* __restrict__ wh,
                 bf16* __restrict__ y, float* __restrict__ gates,
                 bf16* __restrict__ cell, int B, int T, int D, int H, int U,
                 int dm) {
  constexpr int R = F16_M * MT;
  constexpr int NG = f16_ng(MT);
  extern __shared__ __align__(128) unsigned char smf[];
  __shared__ int lens[2 * F16_M];
  const int C = (int)cluster_size();
  const int crank = (int)cluster_rank();
  // The call's directions (dirs_of): nd in the streams, this CTA's at place
  // `dsl`, running forward (dir 0) or reversed.
  const int nd = dirs_of(dm);
  const int dsl = dm ? 0 : (int)blockIdx.y;
  const int dir = dm ? dm - 1 : (int)blockIdx.y;
  const int b0 = (blockIdx.x / C) * R;
  const int k0 = crank * U;
  const int nu = max(0, min(U, H - k0));
  const int G = 4 * H;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;
  const Geo16 geo = geo16(D, H, U, R, HOIST, EMIT);
  const int ldb = geo.ldb, ldh = geo.ldh, ldx = geo.ldx;
  bf16* Bw = reinterpret_cast<bf16*>(smf);
  bf16* Ah = reinterpret_cast<bf16*>(smf + geo.off_ah);
  bf16* Ax = reinterpret_cast<bf16*>(smf + geo.off_ax);  // or the xz ring
  float* gs = reinterpret_cast<float*>(smf + geo.off_gs);
  bf16* hs = reinterpret_cast<bf16*>(smf + geo.off_hs);
  bf16* cs = reinterpret_cast<bf16*>(smf + geo.off_cs);
  const int DX = D + 1;  // rows of [Wx; b]
  wh += (size_t)dsl * G * H;
  if (!HOIST) wx += (size_t)dsl * G * DX;
#ifdef CLSTM_FWD16_PHASES
  unsigned long long pd_[F16_SPANS] = {}, tq_ = 0;
#endif

  if (tid < R) {
    const int b = b0 + tid;
    int L = 0;
    if (b < B) L = lengths ? lengths[b] : T;
    lens[tid] = min(max(L, 0), T);
  }
  // The B operand, zero past the CTA's units and past each part's K:
  // loaded once.
  const int N4 = 4 * nu;
  if (H % 8 == 0) {
    const int KC = geo.KH / 8;
    for (int i = tid; i < geo.N * KC; i += nt) {
      const int n = i / KC, kc = i - n * KC;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (n < N4 && 8 * kc < H)
        v = __ldg(reinterpret_cast<const uint4*>(
            wh + (size_t)(4 * k0 + n) * H + 8 * kc));
      *reinterpret_cast<uint4*>(Bw + (size_t)n * ldb + 8 * kc) = v;
    }
  } else {
    for (int i = tid; i < geo.N * geo.KH; i += nt) {
      const int n = i / geo.KH, k = i - n * geo.KH;
      bf16 v = from_f<bf16>(0.0f);
      if (n < N4 && k < H) v = wh[(size_t)(4 * k0 + n) * H + k];
      Bw[(size_t)n * ldb + k] = v;
    }
  }
  if (!HOIST) {
    for (int i = tid; i < geo.N * geo.KX; i += nt) {
      const int n = i / geo.KX, k = i - n * geo.KX;
      bf16 v = from_f<bf16>(0.0f);
      if (n < N4 && k < DX) v = wx[(size_t)(4 * k0 + n) * DX + k];
      Bw[(size_t)n * ldb + geo.KH + k] = v;
    }
    // The x ring's bias column (1) and the columns past it (0); columns
    // below D are staged at every step.
    for (int i = tid; i < 3 * R * ldx; i += nt)
      Ax[i] = from_f<bf16>(i % ldx == D ? 1.0f : 0.0f);
  }
  // h_0 = 0, and the columns past H in both parities; the h stage past nu.
  for (int i = tid; i < 2 * R * ldh; i += nt) Ah[i] = from_f<bf16>(0.0f);
  for (int i = tid; i < 2 * R * U; i += nt) hs[i] = from_f<bf16>(0.0f);
  __syncthreads();
  int lmax = 0;
  for (int r = 0; r < R; ++r) lmax = max(lmax, lens[r]);

  // x of chain step s for the R rows into ring slot s % 3, columns [0, D),
  // a column pair a copy; zero-filled for rows whose chain has ended.
  const Cols kx = cols_of(D / 2, R, tid, nt);
  auto stage_x = [&](int s) {
    bf16* dst = Ax + (size_t)(s % 3) * R * ldx;
    for (int d = kx.c0; d < D / 2; d += kx.dc)
      for (int r = kx.r0; r < R; r += kx.dr) {
        const int Lr = lens[r];
        const bool valid = s < Lr;
        const int t = dir == 0 ? s : Lr - 1 - s;
        const bf16* src = x + ((size_t)(b0 + r) * T + t) * D + 2 * d;
        cp_async4z(dst + (size_t)r * ldx + 2 * d, valid ? src : x, valid);
      }
  };
  // xz of chain step s for the R rows into ring slot s % 3 ([R][4][U]: the
  // CTA's units of each gate), 8 units (16 bytes) a copy where H is a
  // multiple of 8, else 4, zero-filled for rows whose chain has ended (K4
  // where H is a multiple of 4; elsewhere each lane loads its items' xz
  // itself, load_xz).
  const bool xz_ring = HOIST && H % 4 == 0;
  const int xw = H % 8 == 0 ? 8 : 4, xnw = nu / xw;
  const Cols kz = cols_of(4 * xnw, R, tid, nt);
  const int zg0 = kz.c0 / max(xnw, 1), zu0 = (kz.c0 - zg0 * xnw) * xw;
  auto stage_xz = [&](int s) {
    bf16* dst = Ax + (size_t)(s % 3) * R * 4 * U;
    for (int cc = kz.c0, g = zg0, u = zu0; cc < 4 * xnw;
         cc += kz.dc, g = cc / xnw, u = (cc - g * xnw) * xw)
      for (int r = kz.r0; r < R; r += kz.dr) {
        const int Lr = lens[r];
        const bool valid = s < Lr;
        const int t = dir == 0 ? s : Lr - 1 - s;
        const bf16* src = x + (((size_t)(b0 + r) * T + t) * nd + dsl) * G +
                          g * H + k0 + u;
        bf16* d = dst + ((size_t)r * 4 + g) * U + u;
        if (xw == 8)
          cp_async16z(d, valid ? src : x, valid);
        else
          cp_async8z(d, valid ? src : x, valid);
      }
  };
  auto stage_in = [&](int s) {
    if constexpr (HOIST) {
      if (xz_ring) stage_xz(s);
    } else {
      stage_x(s);
    }
  };
  if (lmax > 0) stage_in(0);
  if (lmax > 1) stage_in(1);
  cp_async_commit();

  // Frames t >= len are padding in both halves: exact zeros (this CTA's
  // units).
  for (int r = 0; r < R && b0 + r < B; ++r) {
    const int Lr = lens[r];
    for (int i = tid; i < (T - Lr) * nu; i += nt) {
      const int t = Lr + i / nu;
      const int kk = k0 + i % nu;
      const size_t f = ((size_t)(b0 + r) * T + t) * nd + dsl;
      y[f * H + kk] = from_f<bf16>(0.0f);
      if constexpr (EMIT) {
        cell[f * H + kk] = from_f<bf16>(0.0f);
        for (int g = 0; g < 4; ++g) gates[f * G + g * H + kk] = 0.0f;
      }
    }
  }
  cp_async_wait<0>();
  // Every CTA of the cluster has initialised its buffers before any h
  // crosses to it.
  cluster_arrive();
  cluster_wait();

  // The warp's n tiles jt[i] (the first ni of them hold units: tile j holds
  // units 2j and 2j + 1), and the lane's item of each tile and m tile:
  // unit 2j + (lane / 2) % 2, row lane/4 (even lane) or lane/4 + 8 (odd).
  const int NTc = (nu + 1) / 2;
  int jt[NG];
  int ni = 0;
#pragma unroll
  for (int i = 0; i < NG; ++i) {
    jt[i] = warp + F16_WARPS * i;
    if (jt[i] < NTc) ni = i + 1;
  }
  const bool odd = lane & 1;
  const int ru = (lane >> 2) + 8 * (lane & 1);  // the item's row in an m tile
  const int uq = (lane >> 1) & 1;               // its unit in an n tile
  int L[NG][MT];
  float c[NG][MT], h[NG][MT];
  [[maybe_unused]] float xzv[NG][MT][4];
  float acc[NG][MT][4];
#pragma unroll
  for (int i = 0; i < NG; ++i)
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int ul = 2 * jt[i] + uq;
      L[i][m] = i < ni && ul < nu ? lens[m * F16_M + ru] : 0;
      c[i][m] = h[i][m] = 0.0f;
    }
  auto zero_acc = [&]() {
#pragma unroll
    for (int i = 0; i < NG; ++i)
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][m][e] = 0.0f;
  };
  // acc = [x_s | 1]·[Wx; b] for the warp's n tiles (K1).
  auto x_part = [&](int s) {
    zero_acc();
    if (ni > 0)
      f16_product<MT, NG>(Ax + (size_t)(s % 3) * R * ldx, ldx, Bw + geo.KH,
                          ldb, jt, ni, geo.KX / 16, acc);
  };
  // xz of chain step s for the lane's items (K4).
  auto load_xz = [&](int s) {
#pragma unroll
    for (int i = 0; i < NG; ++i)
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        xzv[i][m][0] = xzv[i][m][1] = xzv[i][m][2] = xzv[i][m][3] = 0.0f;
        if (s < L[i][m]) {
          const int t = dir == 0 ? s : L[i][m] - 1 - s;
          const bf16* src =
              x + (((size_t)(b0 + m * F16_M + ru) * T + t) * nd + dsl) * G +
              k0 + 2 * jt[i] + uq;
#pragma unroll
          for (int g = 0; g < 4; ++g)
            xzv[i][m][g] = to_f(__ldg(src + (size_t)g * H));
        }
      }
  };
  // The output stage of parity p to y, gates and cell (y alone without
  // EMIT), for the rows whose chain is at step s: runs of 4 units a store
  // where H is a multiple of 4 (16 bytes of gates, 8 of y and cell), else
  // one. Segments 0-3 are the gates, 4 y, 5 the cell.
  constexpr int NSEG = EMIT ? 6 : 1;
  const int GS = 4 * U + 2;  // the gates stage's row stride
  const int sw = H % 4 == 0 ? 4 : 1, snw = nu / sw;
  const Cols ks = cols_of(NSEG * snw, R, tid, nt);
  const int sg0 = ks.c0 / max(snw, 1), su0 = (ks.c0 - sg0 * snw) * sw;
  auto store_stage = [&](int s, int p) {
    const float* g_p = gs + (size_t)p * R * GS;
    const bf16* h_p = hs + (size_t)p * R * U;
    const bf16* c_p = cs + (size_t)p * R * U;
    for (int cc = ks.c0, sg = sg0, u = su0; cc < NSEG * snw;
         cc += ks.dc, sg = cc / snw, u = (cc - sg * snw) * sw)
      for (int r = ks.r0; r < R; r += ks.dr) {
        const int Lr = lens[r];
        if (s >= Lr) continue;
        const int t = dir == 0 ? s : Lr - 1 - s;
        const size_t f = ((size_t)(b0 + r) * T + t) * nd + dsl;
        const int k = k0 + u;
        const int seg = EMIT ? sg : 4;
        if (seg < 4) {
          const float* src = g_p + (size_t)r * GS + seg * U + u;
          float* dst = gates + f * G + seg * H + k;
          if (sw == 4) {
            const float2 a = *reinterpret_cast<const float2*>(src);
            const float2 b = *reinterpret_cast<const float2*>(src + 2);
            *reinterpret_cast<float4*>(dst) = make_float4(a.x, a.y, b.x, b.y);
          } else {
            *dst = *src;
          }
        } else {
          const bf16* src = (seg == 4 ? h_p : c_p) + (size_t)r * U + u;
          bf16* dst = (seg == 4 ? y : cell) + f * H + k;
          if (sw == 4)
            *reinterpret_cast<uint2*>(dst) =
                *reinterpret_cast<const uint2*>(src);
          else
            *dst = *src;
        }
      }
  };

  // The hand-off's columns: (peer q, chunk of 8 units).
  const int hpr = U / F16_UNITS;
  const Cols kh = cols_of(C * hpr, R, tid, nt);
  const int hq0 = kh.c0 / hpr, hch0 = kh.c0 - hq0 * hpr;
  if (lmax > 0) {
    if constexpr (HOIST) {
      if (!xz_ring) load_xz(0);
    } else {
      x_part(0);
    }
  }
#ifdef CLSTM_FWD16_PHASES
  tq_ = clock64();
#endif
  for (int s = 0; s < lmax; ++s) {
    const int p = s & 1;
    if (s > 0) cluster_wait();  // h_s and x_{s+1} are in place
    F16_MARK(0)
    if (s + 2 < lmax) stage_in(s + 2);
    cp_async_commit();
    F16_MARK(1)
    if constexpr (HOIST) zero_acc();
    if (ni > 0)
      f16_product<MT, NG>(Ah + (size_t)p * R * ldh, ldh, Bw, ldb, jt, ni,
                          geo.KH / 16, acc);
    F16_MARK(2)
    // The gate math of the lane's items into the stage of parity p; a row
    // whose chain has ended keeps its state.
    float* g_p = gs + (size_t)p * R * GS;
    bf16* h_p = hs + (size_t)p * R * U;
    bf16* c_p = cs + (size_t)p * R * U;
#pragma unroll
    for (int i = 0; i < NG; ++i) {
      if (i >= ni) continue;  // warp-uniform: every lane takes part
      const int ul = 2 * jt[i] + uq;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = acc[i][m][e];
        const float s0 = __shfl_xor_sync(0xffffffffu, odd ? v[0] : v[2], 1);
        const float s1 = __shfl_xor_sync(0xffffffffu, odd ? v[1] : v[3], 1);
        float z[4] = {odd ? s0 : v[0], odd ? s1 : v[1], odd ? v[2] : s0,
                      odd ? v[3] : s1};
        if constexpr (HOIST) {
          if (!xz_ring) {
#pragma unroll
            for (int g = 0; g < 4; ++g) z[g] += xzv[i][m][g];
          } else if (ul < nu) {
            const bf16* xr = Ax + ((size_t)(s % 3) * R * 4 +
                                   (m * F16_M + ru) * 4) * U + ul;
#pragma unroll
            for (int g = 0; g < 4; ++g) z[g] += to_f(xr[(size_t)g * U]);
          }
        }
        float gt[4];
        gt[0] = sigmoid_f32(z[0]);
        gt[1] = sigmoid_f32(z[1]);
        gt[2] = sigmoid_f32(z[2]);
        gt[3] = tanhf(z[3]);
        const float cn = gt[1] * c[i][m] + gt[0] * gt[3];
        const float hn = tanhf(cn) * gt[2];
        const bool on = s < L[i][m];
        c[i][m] = on ? cn : c[i][m];
        h[i][m] = on ? hn : h[i][m];
        if (ul < nu) {
          const int r = m * F16_M + ru;
          h_p[r * U + ul] = from_f<bf16>(h[i][m]);
          if constexpr (EMIT) {
#pragma unroll
            for (int g = 0; g < 4; ++g)
              g_p[(size_t)r * GS + g * U + ul] = gt[g];
            c_p[r * U + ul] = from_f<bf16>(c[i][m]);
          }
        }
      }
    }
    F16_MARK(3)
    __syncthreads();
    F16_MARK(4)
    if (s + 1 < lmax) {
      // h_{s+1} as the next product's operand: every 16-byte chunk (8
      // units of a row) of the stage into the h operand of the next parity
      // of every CTA of the cluster.
      bf16* dst0 = Ah + (size_t)(p ^ 1) * R * ldh + k0;
      for (int cc = kh.c0, q = hq0, ch = hch0; cc < C * hpr;
           cc += kh.dc, q = cc / hpr, ch = cc - q * hpr) {
        if (k0 + F16_UNITS * ch >= H) continue;
        const uint32_t rank = (uint32_t)q;
        for (int r = kh.r0; r < R; r += kh.dr) {
          const uint4 v = *reinterpret_cast<const uint4*>(
              h_p + r * U + F16_UNITS * ch);
          bf16* dst = dst0 + (size_t)r * ldh + F16_UNITS * ch;
          if (q == crank)
            *reinterpret_cast<uint4*>(dst) = v;
          else
            st_peer16(peer_addr(dst, rank), v);
        }
      }
      F16_MARK(5)
      cp_async_wait<0>();
      cluster_arrive();
      F16_MARK(6)
    }
    // While the other CTAs reach the barrier: the next step's input work,
    // then the outputs (stored after the arrive, whose release would
    // otherwise wait for them; K1 ran faster in turns with its x part
    // first).
    if (s + 1 < lmax) {
      if constexpr (HOIST) {
        if (!xz_ring) load_xz(s + 1);
      } else {
        x_part(s + 1);
      }
    }
    F16_MARK(7)
    store_stage(s, p);
    F16_MARK(8)
  }
#ifdef CLSTM_FWD16_PHASES
  if (tid == 0)
    for (int i = 0; i < F16_SPANS; ++i)
      g_f16_phase[((size_t)blockIdx.y * gridDim.x + blockIdx.x) * F16_SPANS +
                  i] = pd_[i];
#endif
  // No CTA leaves while another may still address its shared memory.
  cluster_arrive();
  cluster_wait();
}

using Fwd16 = void (*)(const bf16*, const int32_t*, const bf16*, const bf16*,
                       bf16*, float*, bf16*, int, int, int, int, int, int);

// The kernel instance of a plan, with its shared-memory limit set and
// clusters past the portable 8 CTAs allowed (F16_WIDE_C), before both the
// occupancy query and the launch.
cudaError_t fwd16_of(bool hoist, bool emit, int R, long long smem,
                     Fwd16* kern) {
  static const Fwd16 table[2][2][2] = {
      {{fwd16_kernel<false, false, 1>, fwd16_kernel<false, false, 2>},
       {fwd16_kernel<false, true, 1>, fwd16_kernel<false, true, 2>}},
      {{fwd16_kernel<true, false, 1>, fwd16_kernel<true, false, 2>},
       {fwd16_kernel<true, true, 1>, fwd16_kernel<true, true, 2>}}};
  *kern = table[hoist][emit][R / F16_M - 1];
  const cudaError_t e = cudaFuncSetAttribute(
      *kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(*kern,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// The launch configuration of a fwd16 plan (Config: clusters of C CTAs).
Plan plan_of16(int C, int R, int U, long long smem) {
  Plan p;
  p.C = C;
  p.R = R;
  p.U = U;
  p.wres = 1;
  p.threads = F16_THREADS;
  p.smem = (size_t)smem;
  return p;
}

template <bool HOIST, bool EMIT>
int launch16(const bf16* x, const int32_t* lengths, const bf16* wx,
             const bf16* wh, bf16* y, float* gates, bf16* cell, int B, int T,
             int D, int H, int C, int R, int U, int dm, void* stream) {
  const long long smem = plan16(D, H, HOIST, EMIT, C, R, U);
  if (B < 1 || T < 1 || smem == 0 || dm < 0 || dm > 2)
    return (int)cudaErrorInvalidValue;
  // Wh's rows are read 16 bytes at a time where H is a multiple of 8.
  if (((uintptr_t)wh & 15) != 0) return (int)cudaErrorMisalignedAddress;
  Fwd16 kern;
  cudaError_t e = fwd16_of(HOIST, EMIT, R, smem, &kern);
  if (e != cudaSuccess) return (int)e;
  const Plan p = plan_of16(C, R, U, smem);
  Config c(p, (unsigned)(C * ((B + R - 1) / R)), (cudaStream_t)stream, dm);
  e = cudaLaunchKernelEx(&c.cfg, kern, x, lengths, wx, wh, y, gates, cell, B,
                         T, D, H, U, dm);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

int clusters16(int D, int H, bool hoist, bool emit, int C, int R, int U) {
  const long long smem = plan16(D, H, hoist, emit, C, R, U);
  if (smem == 0) return -(int)cudaErrorInvalidValue;
  Fwd16 kern;
  cudaError_t e = fwd16_of(hoist, emit, R, smem, &kern);
  if (e != cudaSuccess) return -(int)e;
  Config c(plan_of16(C, R, U, smem), (unsigned)C, nullptr);
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, kern, &c.cfg);
  return e == cudaSuccess ? n : -(int)e;
}

// The FMA kernel's launch in the mode (hoist, emit) with element type E:
// the pointers of what the mode has none of are passed as null, and D as
// 0 with hoist.
template <class E>
int launch_mode(const void* x, const int32_t* lengths, const void* wx,
                const void* wh, void* y, float* gates, void* cell, int B,
                int T, int D, int H, int C, int R, int U, int wres, int hoist,
                int emit, int dm, void* stream) {
  const E* xe = static_cast<const E*>(x);
  const E* wxe = static_cast<const E*>(wx);
  const E* whe = static_cast<const E*>(wh);
  E* ye = static_cast<E*>(y);
  E* ce = static_cast<E*>(cell);
  if (hoist)
    return emit ? launch<true, true, E>(xe, lengths, nullptr, whe, ye, gates,
                                        ce, B, T, 0, H, C, R, U, wres, dm,
                                        stream)
                : launch<false, true, E>(xe, lengths, nullptr, whe, ye,
                                         nullptr, nullptr, B, T, 0, H, C, R,
                                         U, wres, dm, stream);
  return emit ? launch<true, false, E>(xe, lengths, wxe, whe, ye, gates, ce,
                                       B, T, D, H, C, R, U, wres, dm, stream)
              : launch<false, false, E>(xe, lengths, wxe, whe, ye, nullptr,
                                        nullptr, B, T, D, H, C, R, U, wres,
                                        dm, stream);
}

}  // namespace

// Each launching entry runs on `stream` and returns cudaGetLastError() (0
// on success). All pointers are device pointers, the weights 16-byte
// aligned; `lengths` may be NULL (all T). B, T, H >= 1.
//
// The mode: hoist 0 (K3, K1) reads x [B,T,D] and wx; hoist 1 (K4) reads
// the hoisted projection xz [B,T,n,4H] in x's place (wx and D unused).
// emit 1 (K1, K4's state mode) also writes gates [B,T,n,4H] (f32) and cell
// [B,T,n,H]; emit 0 (K3, K4 inference) writes y [B,T,nH] alone (gates and
// cell unused). dm, the call's directions: 0 both (n = 2, the bidi pair;
// the forward direction's streams and weights first), 1 the forward
// direction alone, 2 the reversed one alone (n = 1: a lone NPLSTM or
// Reversed(NPLSTM); the grid takes that direction's row groups). Any other
// dm, and a plan the kernel cannot take, return cudaErrorInvalidValue.
//
// clstm_lstm_fwd launches the FMA kernel at the plan of
// ops/bidi_lstm_kernel.py::fwd_plan: C CTAs per cluster, R rows per
// cluster, U units per CTA, wres 1 the weights resident in shared memory,
// 2 only Wh, 0 none. wx [n,D+1,H,4] holds Wx's rows then b, wh [n,H,H,4]
// Wh, both interleaved by unit (see the note above). bf 0: every stream and
// weight f32; bf 1 (the bf16 mode): x, y, cell and the weights bf16, the
// gates f32, D even. One direction runs in the bf16 mode only (bf 0 with
// dm 1 or 2 returns cudaErrorInvalidValue).
extern "C" int clstm_lstm_fwd(const void* x, const int32_t* lengths,
                              const void* wx, const void* wh, void* y,
                              float* gates, void* cell, int B, int T, int D,
                              int H, int C, int R, int U, int wres, int hoist,
                              int emit, int bf, int dm, void* stream) {
  if (dm != 0 && !bf) return (int)cudaErrorInvalidValue;
  return bf ? launch_mode<bf16>(x, lengths, wx, wh, y, gates, cell, B, T, D,
                                H, C, R, U, wres, hoist, emit, dm, stream)
            : launch_mode<float>(x, lengths, wx, wh, y, gates, cell, B, T, D,
                                 H, C, R, U, wres, hoist, emit, dm, stream);
}

// clstm_lstm_fwd16 launches the tensor-core kernel, the bf16 mode only, at
// the plan of fwd16_plan (C CTAs per cluster, R rows per cluster, U units
// per CTA): x [B,T,D] bf16 (D even), wx [n,4H,D+1] (row 4u+g: the column of
// gate g of unit u, over the rows of Wx then b) and wh [n,4H,H] bf16, k
// contiguous (fwd16_weights); y and cell bf16, the gates f32.
extern "C" int clstm_lstm_fwd16(const bf16* x, const int32_t* lengths,
                                const bf16* wx, const bf16* wh, bf16* y,
                                float* gates, bf16* cell, int B, int T, int D,
                                int H, int C, int R, int U, int hoist,
                                int emit, int dm, void* stream) {
  if (hoist)
    return emit ? launch16<true, true>(x, lengths, nullptr, wh, y, gates, cell,
                                       B, T, 0, H, C, R, U, dm, stream)
                : launch16<true, false>(x, lengths, nullptr, wh, y, nullptr,
                                        nullptr, B, T, 0, H, C, R, U, dm,
                                        stream);
  return emit ? launch16<false, true>(x, lengths, wx, wh, y, gates, cell, B, T,
                                      D, H, C, R, U, dm, stream)
              : launch16<false, false>(x, lengths, wx, wh, y, nullptr, nullptr,
                                       B, T, D, H, C, R, U, dm, stream);
}

// Bytes of dynamic shared memory a CTA of an FMA plan takes (0: the plan is
// not one the kernel takes), bf as clstm_lstm_fwd's.
extern "C" long long clstm_lstm_fwd_smem(int D, int H, int hoist, int C,
                                         int R, int U, int wres, int bf) {
  return bf ? plan_smem<bf16>(D, H, hoist, C, R, U, wres)
            : plan_smem<float>(D, H, hoist, C, R, U, wres);
}

// Clusters of an FMA plan the current device holds at once
// (cudaOccupancyMaxActiveClusters) for the instance of the mode, or minus a
// CUDA error.
extern "C" int clstm_lstm_fwd_clusters(int D, int H, int hoist, int emit,
                                       int C, int R, int U, int wres,
                                       int bf) {
  return bf ? plan_clusters<bf16>(D, H, hoist, emit, C, R, U, wres)
            : plan_clusters<float>(D, H, hoist, emit, C, R, U, wres);
}

// Bytes of dynamic shared memory a CTA of a fwd16 plan takes (0: the plan
// is not one the kernel takes); D is the kernel's (even) x width, 0 with
// hoist (ops/bidi_lstm_kernel.py::fwd16_smem counts the same).
extern "C" long long clstm_lstm_fwd16_smem(int D, int H, int hoist,
                                                int emit, int C, int R,
                                                int U) {
  return plan16(D, H, hoist != 0, emit != 0, C, R, U);
}

// Clusters of a fwd16 plan the current device holds at once
// (cudaOccupancyMaxActiveClusters) for the instance of that mode, or minus
// a CUDA error.
extern "C" int clstm_lstm_fwd16_clusters(int D, int H, int hoist,
                                              int emit, int C, int R,
                                              int U) {
  return clusters16(D, H, hoist != 0, emit != 0, C, R, U);
}

#ifdef CLSTM_FWD16_PHASES
// The cycle counts of the instrumented build (scripts/torch_fwd16_probe.py
// --phases): F16_SPANS spans per CTA, [2][gridDim.x] CTAs.
extern "C" int clstm_fwd16_phases(unsigned long long* out, int n) {
  return (int)cudaMemcpyFromSymbol(
      out, g_f16_phase, sizeof(unsigned long long) * (size_t)n);
}
#endif
