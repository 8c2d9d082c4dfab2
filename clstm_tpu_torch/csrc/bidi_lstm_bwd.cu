// Bidirectional LSTM backward (K2) for sm_90a, f32 and bf16 (the *_bf16
// entry points).
//
// Replaces the TPU kernel clstm_tpu/ops/pallas_lstm.py::_bwd_kernel
// (reached through bidi_lstm_pallas's custom VJP, _vjp_bwd; with proj_in
// as well, since the port stores the gates and never recomputes z). The
// TPU kernel runs the backward chain and then, in its own body, the
// contractions dW += [x|1]ᵀ·dz, dWh += h_prevᵀ·dz and dx = dz·Wxᵀ. Here
// that is a chain kernel and a reduction, with the same contracts as
// clstm_tpu_torch/ops/lstm.py::bidi_lstm_bwd_chain_plain and
// bidi_lstm_bwd_reduce_plain:
//
//   chain (clstm_bidi_lstm_bwd_chain): K1's gates [B,T,2,4H] and cell
//     [B,T,2,H], the cotangent gy [B,T,2H] and WhT [2,4H,Hp] (Wh
//     transposed, rows zero-padded to Hp = H rounded up to a multiple of 4)
//     -> dz [B,T,2,4H]. Each row's valid chain steps are walked backward:
//       dh = gy + Dh;  dc = Dc + dh·go·(1 - tanh²c)
//       dz = [dc·ci·gi(1-gi), dc·c_prev·gf(1-gf), dh·tanh(c)·go(1-go),
//             dc·gi(1-ci²)]
//       Dh = dz·Whᵀ;  Dc = dc·gf
//     (pallas_lstm.py L391-430). The reverse direction's chain step s is
//     frame len-1-s; c_prev is cell at the frame before in chain order, 0
//     at the chain's first step. dz is written exactly 0 on frames t >= len,
//     so padded frames add nothing to any gradient.
//   reduction (clstm_bidi_lstm_bwd_reduce): per direction
//     dW [D+1+H, 4H] = Σ over all B·T frames of [x | 1 | h_prev]ᵀ·dz
//     (rows: dWx, the bias row, dWh; h_prev is y at the frame before in
//     chain order, 0 at t = 0 forward and t = T-1 reverse), and, when dx is
//     asked for, dx [B,T,D] = Σ_dir dz·Wxᵀ (pallas_lstm.py L433-464).
//
// What bounds them, and the design.
//
// Reduction: 8.4e11 flop at bidi2's second layer (B=256, T=1024, D=400,
// H=200, dW and dx), a parallel product. On the f32 pipes (67 TFLOP/s)
// that is >= 12.5 ms; the tensor cores take TF32 at 495 TFLOP/s, but one
// TF32 pass keeps 11 bits of each operand and lands ~1e-4 from the f32
// product, which the training trajectory (PERF.md §6) does not tolerate.
// So each operand is split v = hi + lo, both TF32 (hi = v rounded to
// nearest, lo = the rest, rounded), and the product is taken as
// lo·hi + hi·lo + hi·hi ("3xTF32"): within ~2^-21 of the f32 product per
// term, at a third of the TF32 rate (165 TFLOP/s). The tensor cores do not
// round to nearest when they accumulate, so each stage of frames (or dz
// columns) accumulates from 0 and is then added to the f32 sum with an
// ordinary add.
//   - dW: mma.sync m16n8k8 tiles, 64x128 outputs per block (rows of
//     [x | h_prev | 1], gate columns), 32x32 per warp, two blocks per SM;
//     slices staged frame-major, as they lie, by cp.async in a ring. The
//     frame axis is the product's K and the slow axis of both operands,
//     while TF32 wgmma takes shared-memory operands only K-major; a wgmma
//     version that transposes dz on the way in was right but slower, so
//     dW stays on mma.sync. The sum over B·T frames is split into a fixed
//     number of frame ranges sized to fill the card, each written to its
//     own partial buffer, and a second pass adds them in a fixed order:
//     deterministic, no float atomics. The A operand is staged as
//     [x | h_prev | 1] (the bias column last), so that with D and H
//     multiples of 4 every 16-byte chunk comes from one source and frame.
//   - dx = dz·Wcat: both operands lie K-major, so dx runs on wgmma, A (dz)
//     from registers, B from hi and lo copies of wx split once per call;
//     the 2·4H columns of a frame are summed inside one block:
//     deterministic as well.
//
// Chain: a serial recurrence of T steps per row tile; per step a
// [ROWS,4H] x [4H,H] product (Dh) after the elementwise gate algebra, two
// block barriers. Its bound is latency, the shared-memory pipe and, where
// WhT does not fit in shared memory, L2 bandwidth: not device-memory bytes
// or flops. grid = (ceil(B/4) row tiles, 2 directions), one block walking
// its tile's chain (128 blocks at B=256, one per SM):
//   - step s-1's gates, cell, c_prev and gy are copied into a shared-memory
//     slot by cp.async while step s runs (two slots), so their latency is
//     off the serial path;
//   - phase A: a thread per (row, unit) forms dh, dc, dz and Dc, with Dh
//     the sum of phase B's partials in a fixed order;
//   - phase B: a register tile per thread: 4 consecutive units k for all
//     rows over a fixed range of the 4H dz columns j (the column range is
//     split across threads, and phase A adds the partials). dz is read as
//     float4 (4 j per shared load) and WhT as float4 (4 units per load), so
//     a shared or L2 load feeds 4·ROWS FMAs, not one;
//   - WhT sits in shared memory when it fits with the rest (H <= ~100),
//     else it is read from L2 (640 KB per direction and step at H=200,
//     which L2's bandwidth bounds); 8-row tiles, which halve those reads,
//     were slower: their FMA work per SM doubles on half the SMs.
//   The recurrent product stays on the FMA pipes: a 4-row tile would fill a
//   quarter of an m16 MMA. dz is summed in another order than the plain
//   loop's (by column range, not by gate block): within ~1e-7 of it, and
//   bitwise the same from call to call.
//
// The bf16 mode (the JAX package's xz_bf16=True, pallas_lstm.py L385-463):
//   - chain (clstm_bidi_lstm_bwd_chain_bf16): cell, gy, WhT and dz are bf16,
//     the gates f32 (as K1 stores them in both modes); the math and the Dh
//     and Dc carries stay f32; dz is rounded to bf16 where it is stored and
//     where it enters Dh = dz·Whᵀ (the shared dz buffer holds the rounded
//     values in f32). WhT takes half the bytes, so it stays in shared memory
//     to H ~ 140 and is half the L2 reads past that.
//   - reduction (clstm_bidi_lstm_bwd_reduce_bf16): x, h_prev (y) and dz are
//     bf16 and every product is one bf16 mma.sync m16n8k16 pass with f32
//     accumulation, in place of 3xTF32's three: dW on the tiles and frame
//     ranges of the f32 kernel (the same fixed-order sum of partials), the
//     A and B fragments gathered from the frame-major slices element by
//     element; dx per direction as a product of dz's rows and wx's rows
//     (both K-contiguous, so each fragment register is one 32-bit load),
//     each direction's sum rounded to bf16 and the two added in f32
//     (pallas_lstm.py L913-917), written in x's type.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// bf16 values
// ---------------------------------------------------------------------------

// The f32 values of a bf16 pair packed in 32 bits: the first element in the
// low half.
__device__ __forceinline__ float lo_f(uint32_t u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float hi_f(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// 4 consecutive bf16 (8 bytes) as f32.
__device__ __forceinline__ float4 ld4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(lo_f(u.x), hi_f(u.x), lo_f(u.y), hi_f(u.y));
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <class E>
__device__ __forceinline__ E from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// v as an operand of a product of the mode: rounded to bf16 in the bf16
// mode.
template <class E>
__device__ __forceinline__ float operand(float v) {
  return to_f(from_f<E>(v));
}

// The raw bits of a bf16.
__device__ __forceinline__ uint32_t bits(bf16 v) {
  return (uint32_t)__bfloat16_as_ushort(v);
}

// ---------------------------------------------------------------------------
// cp.async and the 3xTF32 tensor-core product
// ---------------------------------------------------------------------------

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared; zero-filled when !valid (src is not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// 4 bytes global -> shared; zero-filled when !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

// 8 bytes global -> shared; zero-filled when !valid.
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 8 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// v rounded to TF32 (10-bit mantissa, to nearest, ties away from zero: the
// rounding of cvt.rna.tf32.f32), as f32 bits. Two integer operations on the
// bits, which issue at the full rate where the conversion does not.
__device__ __forceinline__ uint32_t to_tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// v = hi + lo, both TF32: lo is v - hi (exact in f32) rounded to TF32.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(v);
  lo = to_tf32(v - __uint_as_float(hi));
}

// c += a·b, one m16n8k8 TF32 tile, f32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One warp's share of a staged BK-deep slice, in 3xTF32: acc[mi][ni] +=
// A[16mi.., k]·B[k, 8ni..] for k < BK. a_at(m, k) and b_at(k, n) read the
// staged tiles at the warp's offsets. Fragment layout of m16n8k8 (g = lane
// / 4, t = lane % 4): a = A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4];
// b = B[t][g], B[t+4][g]; c = C[g][2t], C[g][2t+1], C[g+8][2t],
// C[g+8][2t+1]. The three passes run outermost, so the MI·NI tiles give
// each accumulator's dependent MMAs room between them.
template <int MI, int NI, int BK, class FA, class FB>
__device__ __forceinline__ void mma_slice_3xtf32(float (&acc)[MI][NI][4],
                                                 FA a_at, FB b_at) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int k0 = 0; k0 < BK; k0 += 8) {
    uint32_t ah[MI][4], al[MI][4], bh[NI][2], bl[NI][2];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      split_tf32(a_at(16 * mi + g, k0 + t), ah[mi][0], al[mi][0]);
      split_tf32(a_at(16 * mi + g + 8, k0 + t), ah[mi][1], al[mi][1]);
      split_tf32(a_at(16 * mi + g, k0 + t + 4), ah[mi][2], al[mi][2]);
      split_tf32(a_at(16 * mi + g + 8, k0 + t + 4), ah[mi][3], al[mi][3]);
    }
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      split_tf32(b_at(k0 + t, 8 * ni + g), bh[ni][0], bl[ni][0]);
      split_tf32(b_at(k0 + t + 4, 8 * ni + g), bh[ni][1], bl[ni][1]);
    }
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) mma_tf32(acc[mi][ni], al[mi], bh[ni]);
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) mma_tf32(acc[mi][ni], ah[mi], bl[ni]);
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) mma_tf32(acc[mi][ni], ah[mi], bh[ni]);
  }
}

// Run a staged product over k tiles 0..KT-1 with a STAGES-deep cp.async
// ring: load(stage, kt) issues tile kt's copies into ring slot `stage`,
// compute(stage) runs on a slot whose copies have landed. Each slot is
// overwritten only after the barrier that follows its last reader.
template <int STAGES, class FL, class FC>
__device__ __forceinline__ void pipeline(int KT, FL load, FC compute) {
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int next = kt + STAGES - 1;
    if (next < KT) load(next % STAGES, next);
    cp_async_commit();
    compute(kt % STAGES);
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// Reduction: dW partials, their fixed-order sum, dx
// ---------------------------------------------------------------------------

constexpr int RED_THREADS = 256;  // 8 warps
constexpr int STAGES = 3;
constexpr int BK = 32;            // frames (dW) or dz columns (dx) per slice

// dW: 64x128 output tile (rows of [x | h_prev | 1], gate columns), warps
// 2 (rows) x 4 (columns), 32x32 per warp: ~120 registers, so two blocks
// share an SM. Slices are staged frame-major, as they lie in memory:
// As[frame][row], Bs[frame][column]; rows of 72 and 136 floats put a
// fragment's 32 reads in 32 banks.
constexpr int DW_MI = 2;  // 16-row fragments per warp
constexpr int DW_BM = 2 * 16 * DW_MI, DW_BN = 128;
constexpr int DW_LDA = DW_BM + 8, DW_LDB = DW_BN + 8;
constexpr int DW_STAGE = BK * (DW_LDA + DW_LDB);  // floats per ring slot
constexpr size_t DW_SMEM = (size_t)STAGES * DW_STAGE * sizeof(float);

// Block (output tile, dir * nsplit + split) sums its frame range
// [split*chunk, (split+1)*chunk) of [x | h_prev | 1]ᵀ·dz into
// part[split][dir][i][j], i < D+1+H (dW's row order), j < 4H. VEC: D and H
// are multiples of 4, so A is staged in 16-byte chunks.
template <bool VEC>
__global__ void __launch_bounds__(RED_THREADS, 2)
    bwd_dw_partial_kernel(const float* __restrict__ x,
                          const float* __restrict__ y,
                          const float* __restrict__ dz,
                          float* __restrict__ part, int B, int T, int D,
                          int H, int nsplit, int chunk) {
  extern __shared__ __align__(16) float smem[];
  const int G = 4 * H, M = D + 1 + H;
  const int ntile_j = (G + DW_BN - 1) / DW_BN;
  const int i0 = (blockIdx.x / ntile_j) * DW_BM;  // row of [x | h_prev | 1]
  const int j0 = (blockIdx.x % ntile_j) * DW_BN;
  const int dir = blockIdx.y / nsplit;
  const int sp = blockIdx.y - dir * nsplit;
  const int N = B * T;
  const int n_begin = sp * chunk;
  const int n_end = min(N, n_begin + chunk);
  const int KT = n_end > n_begin ? (n_end - n_begin + BK - 1) / BK : 0;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = (warp >> 2) * 16 * DW_MI, wn = (warp & 3) * 32;

  // Column i of [x | h_prev | 1] at frame n, as a pointer (nullptr: 0,
  // ones: the bias column).
  auto load = [&](int stage, int kt) {
    float* As = smem + stage * DW_STAGE;
    float* Bs = As + BK * DW_LDA;
    const int n0 = n_begin + kt * BK;
    if (VEC) {
      for (int c = tid; c < BK * DW_BM / 4; c += RED_THREADS) {
        const int kk = c / (DW_BM / 4), i = i0 + (c % (DW_BM / 4)) * 4;
        const int n = n0 + kk;
        float* dst = As + kk * DW_LDA + (i - i0);
        const float* src = x;
        bool ok = false;
        if (n < n_end) {
          if (i < D) {
            src = x + (size_t)n * D + i;
            ok = true;
          } else if (i < D + H) {
            const int k = i - D, t = n % T;
            if (dir == 0 && t > 0) {
              src = y + (size_t)(n - 1) * 2 * H + k;
              ok = true;
            } else if (dir == 1 && t + 1 < T) {
              src = y + (size_t)(n + 1) * 2 * H + H + k;
              ok = true;
            }
          } else if (i == D + H) {
            dst[0] = 1.0f;
            dst[1] = dst[2] = dst[3] = 0.0f;
            continue;
          }
        }
        cp_async16(dst, src, ok);
      }
    } else {
      for (int e = tid; e < BK * DW_BM; e += RED_THREADS) {
        const int kk = e / DW_BM, i = i0 + e % DW_BM;
        const int n = n0 + kk;
        float* dst = As + kk * DW_LDA + (i - i0);
        const float* src = x;
        bool ok = false;
        if (n < n_end) {
          if (i < D) {
            src = x + (size_t)n * D + i;
            ok = true;
          } else if (i < D + H) {
            const int k = i - D, t = n % T;
            if (dir == 0 && t > 0) {
              src = y + (size_t)(n - 1) * 2 * H + k;
              ok = true;
            } else if (dir == 1 && t + 1 < T) {
              src = y + (size_t)(n + 1) * 2 * H + H + k;
              ok = true;
            }
          } else if (i == D + H) {
            *dst = 1.0f;
            continue;
          }
        }
        cp_async4(dst, src, ok);
      }
    }
    for (int c = tid; c < BK * DW_BN / 4; c += RED_THREADS) {
      const int kk = c / (DW_BN / 4), j = j0 + (c % (DW_BN / 4)) * 4;
      const int n = n0 + kk;
      const bool ok = n < n_end && j < G;
      cp_async16(Bs + kk * DW_LDB + (j - j0),
                 ok ? dz + ((size_t)n * 2 + dir) * G + j : dz, ok);
    }
  };

  float acc[DW_MI][4][4] = {};
  auto compute = [&](int stage) {
    const float* As = smem + stage * DW_STAGE;
    const float* Bs = As + BK * DW_LDA;
    float tmp[DW_MI][4][4] = {};
    mma_slice_3xtf32<DW_MI, 4, BK>(
        tmp, [&](int m, int k) { return As[k * DW_LDA + wm + m]; },
        [&](int k, int n) { return Bs[k * DW_LDB + wn + n]; });
#pragma unroll
    for (int mi = 0; mi < DW_MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mi][ni][q] += tmp[mi][ni][q];
  };
  pipeline<STAGES>(KT, load, compute);

  // Staged row i -> dW row: x rows stay, h_prev rows move down one, the
  // ones column is the bias row D.
  float* out = part + ((size_t)sp * 2 + dir) * M * G;
  const int lane = tid & 31, g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int mi = 0; mi < DW_MI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = i0 + wm + 16 * mi + g + 8 * h;
      if (i >= M) continue;
      const int row = i < D ? i : (i < D + H ? i + 1 : D);
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int j = j0 + wn + 8 * ni + 2 * t4 + q;
          if (j < G) out[(size_t)row * G + j] = acc[mi][ni][2 * h + q];
        }
    }
}

// dW = Σ over splits, in split order.
__global__ void bwd_dw_sum_kernel(const float* __restrict__ part,
                                  float* __restrict__ dw, int nsplit,
                                  int total) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  float acc = 0.0f;
  for (int sp = 0; sp < nsplit; ++sp) acc += part[(size_t)sp * total + e];
  dw[e] = acc;
}

// dx [N, D] = dz [N, 2·4H] · Wcat [2·4H, D] on wgmma (sm_90a), where
// Wcat[q][d] = wx[q / 4H][d][q % 4H]. Both operands already lie K-major (q
// contiguous), as TF32 wgmma requires of an operand in shared memory:
//   - A (dz, 64 frames per warpgroup) is staged by cp.async, read into
//     registers in the m16n8k8 fragment layout of each warp's 16 rows, and
//     split into hi and lo there;
//   - B (Wcat, 80 columns d) is split once per call into hi and lo copies
//     of wx (bwd_split_kernel), staged by cp.async in the no-swizzle
//     K-major layout: 8-row x 16-byte core matrices, the two K halves of a
//     k8 step 128 B apart (LBO), 8-row groups DXW_BK/4 · 128 B apart (SBO).
// Each k8 step issues lo·hi, hi·lo, hi·hi as three m64n80k8 wgmmas into a
// per-stage sum, added to the f32 total after the stage (as for dW).
constexpr int DXW_WG = 4;               // warpgroups per block
constexpr int DXW_BM = 64 * DXW_WG;     // frames per block
constexpr int DXW_BN = 80;              // d columns per block (wgmma N)
constexpr int DXW_BK = 16;              // q per stage
constexpr int DXW_STAGES = 4;
constexpr int DXW_LDA = DXW_BK + 4;     // padded A row (conflict-free LDS)
constexpr int DXW_A = DXW_BM * DXW_LDA;  // floats of A per stage
constexpr int DXW_B = DXW_BN * DXW_BK;   // floats of B hi (or lo) per stage
constexpr int DXW_STAGE = DXW_A + 2 * DXW_B;
constexpr size_t DXW_SMEM = (size_t)DXW_STAGES * DXW_STAGE * sizeof(float);
constexpr int DXW_SBO = DXW_BK / 4 * 128;  // bytes between 8-row groups

// wgmma matrix descriptor of a no-swizzle K-major tile at shared address
// `addr`: start >> 4, LBO (bits 16-29) and SBO (bits 32-45) in 16 B units.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(DXW_SBO >> 4) << 32);
}

// d (+)= a·B for one m64n80k8 TF32 step: a in registers (this warp's 16
// rows, m16n8k8 layout), B by descriptor; scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n80k8(float (&d)[40],
                                               const uint32_t (&a)[4],
                                               uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, {%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d));
}

// Keeps the compiler from moving accesses of v across an asynchronous
// wgmma that reads or writes it.
__device__ __forceinline__ void pin(float& v) {
  asm volatile("" : "+f"(v)::"memory");
}
__device__ __forceinline__ void pin(uint32_t& v) {
  asm volatile("" : "+r"(v)::"memory");
}

// wx [2, D, 4H] -> its TF32 hi and lo parts (wx = hi + lo), for dx's B.
__global__ void bwd_split_kernel(const float* __restrict__ wx,
                                 float* __restrict__ hi,
                                 float* __restrict__ lo, int total) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  uint32_t h, l;
  split_tf32(wx[e], h, l);
  hi[e] = __uint_as_float(h);
  lo[e] = __uint_as_float(l);
}

// Block b takes d tile b % ntd of frame tile b / ntd: the d tiles of one
// frame tile run side by side and share its dz in L2.
__global__ void __launch_bounds__(128 * DXW_WG, 1)
    bwd_dx_kernel(const float* __restrict__ dz, const float* __restrict__ whi,
                  const float* __restrict__ wlo, float* __restrict__ dx,
                  int N, int D, int H) {
  extern __shared__ __align__(128) float smem[];
  const int G = 4 * H, K = 2 * G;
  const int ntd = (D + DXW_BN - 1) / DXW_BN;
  const int d0 = (blockIdx.x % ntd) * DXW_BN;
  const int n0 = (blockIdx.x / ntd) * DXW_BM;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int row0 = (tid >> 5) * 16;  // this warp's first row of the tile

  auto load = [&](int stage, int kt) {
    float* As = smem + stage * DXW_STAGE;
    float* Bh = As + DXW_A;
    float* Bl = Bh + DXW_B;
    const int q0 = kt * DXW_BK;
    for (int c = tid; c < DXW_BM * DXW_BK / 4; c += nt) {
      const int m = c / (DXW_BK / 4), q = q0 + (c % (DXW_BK / 4)) * 4;
      const int n = n0 + m;
      const bool ok = n < N && q < K;
      cp_async16(As + m * DXW_LDA + (q - q0),
                 ok ? dz + (size_t)n * K + q : dz, ok);
    }
    for (int c = tid; c < DXW_BN * DXW_BK / 4; c += nt) {
      const int dd = c / (DXW_BK / 4), qc = c % (DXW_BK / 4);
      const int d = d0 + dd, q = q0 + 4 * qc;
      const bool ok = d < D && q < K;
      const int dir = q < G ? 0 : 1;
      const size_t src = ((size_t)dir * D + d) * G + (q - dir * G);
      const int dst = (dd / 8) * (DXW_SBO / 4) + qc * 32 + (dd % 8) * 4;
      cp_async16(Bh + dst, ok ? whi + src : whi, ok);
      cp_async16(Bl + dst, ok ? wlo + src : wlo, ok);
    }
  };

  float acc[40] = {}, tmp[40] = {};
  const int KT = (K + DXW_BK - 1) / DXW_BK;
#pragma unroll
  for (int s = 0; s < DXW_STAGES - 1; ++s) {
    if (s < KT) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<DXW_STAGES - 2>();
    // cp.async wrote through the generic proxy; wgmma reads through the
    // async proxy.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const int next = kt + DXW_STAGES - 1;
    if (next < KT) load(next % DXW_STAGES, next);
    cp_async_commit();

    const float* As = smem + (kt % DXW_STAGES) * DXW_STAGE;
    const uint32_t bh = smem_addr(As + DXW_A), bl = bh + DXW_B * 4;
    uint32_t ah[DXW_BK / 8][4], al[DXW_BK / 8][4];
#pragma unroll
    for (int ks = 0; ks < DXW_BK / 8; ++ks) {
      const float* a = As + (row0 + g) * DXW_LDA + 8 * ks + t4;
      split_tf32(a[0], ah[ks][0], al[ks][0]);
      split_tf32(a[8 * DXW_LDA], ah[ks][1], al[ks][1]);
      split_tf32(a[4], ah[ks][2], al[ks][2]);
      split_tf32(a[8 * DXW_LDA + 4], ah[ks][3], al[ks][3]);
    }
#pragma unroll
    for (int i = 0; i < 40; ++i) pin(tmp[i]);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int ks = 0; ks < DXW_BK / 8; ++ks) {
      // A k8 step spans two core matrices along K: 256 bytes.
      const uint64_t dh = wgmma_desc(bh + 256 * ks);
      const uint64_t dl = wgmma_desc(bl + 256 * ks);
      wgmma_m64n80k8(tmp, al[ks], dh, ks > 0);
      wgmma_m64n80k8(tmp, ah[ks], dl, 1);
      wgmma_m64n80k8(tmp, ah[ks], dh, 1);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int i = 0; i < 40; ++i) pin(tmp[i]);
#pragma unroll
    for (int ks = 0; ks < DXW_BK / 8; ++ks)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pin(ah[ks][i]);
        pin(al[ks][i]);
      }
#pragma unroll
    for (int i = 0; i < 40; ++i) acc[i] += tmp[i];
  }
  cp_async_wait<0>();

  // acc[4i + 2h + c] = (row row0 + g + 8h, column 8i + 2t4 + c).
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = n0 + row0 + g + 8 * h;
    if (n >= N) continue;
#pragma unroll
    for (int i = 0; i < DXW_BN / 8; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int d = d0 + 8 * i + 2 * t4 + c;
        if (d < D) dx[(size_t)n * D + d] = acc[4 * i + 2 * h + c];
      }
  }
}

// ---------------------------------------------------------------------------
// Reduction in the bf16 mode: one bf16 tensor-core pass
// ---------------------------------------------------------------------------

// c += a·b, one m16n8k16 bf16 tile, f32 accumulate. Fragments (g = lane / 4,
// t = lane % 4; each register two bf16, the lower column first): a =
// A[g][2t..], A[g+8][2t..], A[g][2t+8..], A[g+8][2t+8..]; b = B[2t..][g],
// B[2t+8..][g]; c as for m16n8k8.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  return bits(lo) | (bits(hi) << 16);
}

// dW in bf16: the f32 kernel's output tile (64 rows of [x | h_prev | 1] x
// 128 gate columns, 2x4 warps of 32x32), frame ranges and partial buffers,
// on slices of BK = 32 frames staged frame-major in bf16: As[frame][row],
// Bs[frame][column]; rows of 72 and 136 elements put a fragment's 32 loads
// in distinct banks. A fragment's pairs run along the frame axis, which is
// the slow axis of both slices, so each is gathered from two 16-bit loads.
// VEC: D and H multiples of 4, x and y 8-byte aligned: A is staged in
// 8-byte copies, else element by element.
constexpr int DWB_STAGE = BK * (DW_LDA + DW_LDB);  // bf16 per ring slot
constexpr size_t DWB_SMEM = (size_t)STAGES * DWB_STAGE * sizeof(bf16);

template <bool VEC>
__global__ void __launch_bounds__(RED_THREADS, 2)
    bwd_dw_partial_bf16_kernel(const bf16* __restrict__ x,
                               const bf16* __restrict__ y,
                               const bf16* __restrict__ dz,
                               float* __restrict__ part, int B, int T, int D,
                               int H, int nsplit, int chunk) {
  extern __shared__ __align__(16) bf16 smb[];
  const int G = 4 * H, M = D + 1 + H;
  const int ntile_j = (G + DW_BN - 1) / DW_BN;
  const int i0 = (blockIdx.x / ntile_j) * DW_BM;  // row of [x | h_prev | 1]
  const int j0 = (blockIdx.x % ntile_j) * DW_BN;
  const int dir = blockIdx.y / nsplit;
  const int sp = blockIdx.y - dir * nsplit;
  const int N = B * T;
  const int n_begin = sp * chunk;
  const int n_end = min(N, n_begin + chunk);
  const int KT = n_end > n_begin ? (n_end - n_begin + BK - 1) / BK : 0;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = (warp >> 2) * 16 * DW_MI, wn = (warp & 3) * 32;
  const bf16 zero = from_f<bf16>(0.0f), one = from_f<bf16>(1.0f);

  // Element i of [x | h_prev | 1] at frame n, as a pointer (nullptr: 0 or,
  // for i == D + H, the bias column's 1).
  auto src_of = [&](int n, int i) -> const bf16* {
    if (n >= n_end) return nullptr;
    if (i < D) return x + (size_t)n * D + i;
    if (i < D + H) {
      const int k = i - D, t = n % T;
      if (dir == 0 && t > 0) return y + (size_t)(n - 1) * 2 * H + k;
      if (dir == 1 && t + 1 < T) return y + (size_t)(n + 1) * 2 * H + H + k;
    }
    return nullptr;
  };
  auto load = [&](int stage, int kt) {
    bf16* As = smb + stage * DWB_STAGE;
    bf16* Bs = As + BK * DW_LDA;
    const int n0 = n_begin + kt * BK;
    if (VEC) {
      for (int c = tid; c < BK * DW_BM / 4; c += RED_THREADS) {
        const int kk = c / (DW_BM / 4), i = i0 + (c % (DW_BM / 4)) * 4;
        const int n = n0 + kk;
        bf16* dst = As + kk * DW_LDA + (i - i0);
        if (i == D + H && n < n_end) {
          dst[0] = one;
          dst[1] = dst[2] = dst[3] = zero;
          continue;
        }
        const bf16* src = src_of(n, i);
        cp_async8(dst, src ? src : x, src != nullptr);
      }
    } else {
      for (int e = tid; e < BK * DW_BM; e += RED_THREADS) {
        const int kk = e / DW_BM, i = i0 + e % DW_BM;
        const int n = n0 + kk;
        const bf16* src = src_of(n, i);
        As[kk * DW_LDA + (i - i0)] =
            src ? *src : (i == D + H && n < n_end ? one : zero);
      }
    }
    for (int c = tid; c < BK * DW_BN / 4; c += RED_THREADS) {
      const int kk = c / (DW_BN / 4), j = j0 + (c % (DW_BN / 4)) * 4;
      const int n = n0 + kk;
      const bool ok = n < n_end && j < G;
      cp_async8(Bs + kk * DW_LDB + (j - j0),
                ok ? dz + ((size_t)n * 2 + dir) * G + j : dz, ok);
    }
  };

  float acc[DW_MI][4][4] = {};
  const int lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  auto compute = [&](int stage) {
    const bf16* As = smb + stage * DWB_STAGE;
    const bf16* Bs = As + BK * DW_LDA;
    float tmp[DW_MI][4][4] = {};
#pragma unroll
    for (int k0 = 0; k0 < BK; k0 += 16) {
      // A[m][k] = As[k][wm + m]; B[k][n] = Bs[k][wn + n].
      auto a_at = [&](int m, int k) { return As[k * DW_LDA + wm + m]; };
      auto b_at = [&](int k, int n) { return Bs[k * DW_LDB + wn + n]; };
      uint32_t a[DW_MI][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < DW_MI; ++mi)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int m = 16 * mi + g + 8 * (q & 1);
          const int k = k0 + 2 * t4 + 8 * (q >> 1);
          a[mi][q] = pack2(a_at(m, k), a_at(m, k + 1));
        }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int k = k0 + 2 * t4 + 8 * q, n = 8 * ni + g;
          b[ni][q] = pack2(b_at(k, n), b_at(k + 1, n));
        }
#pragma unroll
      for (int mi = 0; mi < DW_MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(tmp[mi][ni], a[mi], b[ni]);
    }
#pragma unroll
    for (int mi = 0; mi < DW_MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mi][ni][q] += tmp[mi][ni][q];
  };
  pipeline<STAGES>(KT, load, compute);

  // Staged row i -> dW row: x rows stay, h_prev rows move down one, the
  // ones column is the bias row D.
  float* out = part + ((size_t)sp * 2 + dir) * M * G;
#pragma unroll
  for (int mi = 0; mi < DW_MI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = i0 + wm + 16 * mi + g + 8 * h;
      if (i >= M) continue;
      const int row = i < D ? i : (i < D + H ? i + 1 : D);
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int j = j0 + wn + 8 * ni + 2 * t4 + q;
          if (j < G) out[(size_t)row * G + j] = acc[mi][ni][2 * h + q];
        }
    }
}

// dx in bf16: dx[n][d] = bf16(Σ_q dz[n][0][q]·wx[0][d][q]) +
// bf16(Σ_q dz[n][1][q]·wx[1][d][q]), in OUT (x's type). A block takes 128
// frames x 64 columns d, 8 warps of 32x32 (2x4 warps along frames and d),
// each direction's q in slices of 32 through a cp.async ring; both operands
// lie q-contiguous, so a fragment register is one 32-bit load. Rows of 40
// elements keep a fragment's loads in distinct banks.
constexpr int DXB_BM = 128, DXB_BN = 64, DXB_BK = 32, DXB_LD = DXB_BK + 8;
constexpr int DXB_STAGE = (DXB_BM + DXB_BN) * DXB_LD;  // bf16 per slot
constexpr size_t DXB_SMEM = (size_t)STAGES * DXB_STAGE * sizeof(bf16);

template <class OUT>
__global__ void __launch_bounds__(RED_THREADS)
    bwd_dx_bf16_kernel(const bf16* __restrict__ dz,
                       const bf16* __restrict__ wx, OUT* __restrict__ dx,
                       int N, int D, int H) {
  extern __shared__ __align__(16) bf16 smb[];
  const int G = 4 * H;
  const int ntd = (D + DXB_BN - 1) / DXB_BN;
  const int d0 = (blockIdx.x % ntd) * DXB_BN;
  const int n0 = (blockIdx.x / ntd) * DXB_BM;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int KT = (G + DXB_BK - 1) / DXB_BK;
  float res[2][4][4] = {};  // the rounded sum of the directions done
  for (int dir = 0; dir < 2; ++dir) {
    auto load = [&](int stage, int kt) {
      bf16* As = smb + stage * DXB_STAGE;
      bf16* Bs = As + DXB_BM * DXB_LD;
      const int q0 = kt * DXB_BK;
      for (int c = tid; c < DXB_BM * DXB_BK / 4; c += RED_THREADS) {
        const int m = c / (DXB_BK / 4), q = q0 + (c % (DXB_BK / 4)) * 4;
        const bool ok = n0 + m < N && q < G;
        cp_async8(As + m * DXB_LD + (q - q0),
                  ok ? dz + ((size_t)(n0 + m) * 2 + dir) * G + q : dz, ok);
      }
      for (int c = tid; c < DXB_BN * DXB_BK / 4; c += RED_THREADS) {
        const int dd = c / (DXB_BK / 4), q = q0 + (c % (DXB_BK / 4)) * 4;
        const bool ok = d0 + dd < D && q < G;
        cp_async8(Bs + dd * DXB_LD + (q - q0),
                  ok ? wx + ((size_t)dir * D + d0 + dd) * G + q : wx, ok);
      }
    };
    float acc[2][4][4] = {};
    auto compute = [&](int stage) {
      const bf16* As = smb + stage * DXB_STAGE;
      const bf16* Bs = As + DXB_BM * DXB_LD;
      float tmp[2][4][4] = {};
#pragma unroll
      for (int k0 = 0; k0 < DXB_BK; k0 += 16) {
        uint32_t a[2][4], b[4][2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int m = wm + 16 * mi + g + 8 * (q & 1);
            const int k = k0 + 2 * t4 + 8 * (q >> 1);
            a[mi][q] = *reinterpret_cast<const uint32_t*>(As + m * DXB_LD + k);
          }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int n = wn + 8 * ni + g, k = k0 + 2 * t4 + 8 * q;
            b[ni][q] = *reinterpret_cast<const uint32_t*>(Bs + n * DXB_LD + k);
          }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) mma_bf16(tmp[mi][ni], a[mi], b[ni]);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[mi][ni][q] += tmp[mi][ni][q];
    };
    pipeline<STAGES>(KT, load, compute);
    __syncthreads();  // the ring is free for the next direction
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          res[mi][ni][q] += operand<bf16>(acc[mi][ni][q]);
  }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + wm + 16 * mi + g + 8 * h;
      if (n >= N) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int d = d0 + wn + 8 * ni + 2 * t4 + q;
          if (d < D)
            dx[(size_t)n * D + d] = from_f<OUT>(res[mi][ni][2 * h + q]);
        }
    }
}

// ---------------------------------------------------------------------------
// Chain
// ---------------------------------------------------------------------------

struct ChainPlan {
  int rows;   // rows per block
  bool wsmem; // WhT in shared memory
  int hp;     // H rounded up to a multiple of 4
  int parts;  // column ranges of phase B
  int jp;     // dz columns per range (a multiple of 4)
  int threads;
  size_t smem;
};

// Bytes of shared memory a block may use on sm_90, less the static lens.
constexpr int SMEM_MAX = 232448 - 64;
constexpr int CHAIN_THREADS = 512;

// Bytes of one step's slot per row: the gates (4H f32), then cell, c_prev
// and gy (Hp elements of es bytes each), rounded up to 16.
__host__ __device__ inline int slot_bytes(int G, int hp, int es) {
  return (4 * G + 3 * hp * es + 15) / 16 * 16;
}

// Phase B runs Hp/4 unit groups times `parts` column ranges on at most
// CHAIN_THREADS threads (so H <= 2048). es: bytes of WhT's elements and of
// the bf16-able streams (4 f32, 2 bf16).
ChainPlan chain_plan(int H, bool wsmem, int rows, int es) {
  ChainPlan p;
  const int G = 4 * H;
  p.rows = rows;
  p.wsmem = wsmem;
  p.hp = (H + 3) / 4 * 4;
  const int kg = p.hp / 4;
  int parts = CHAIN_THREADS / kg;
  parts = parts < 1 ? 1 : (parts > G / 4 ? G / 4 : parts);
  p.jp = (G / 4 + parts - 1) / parts * 4;
  p.parts = (G + p.jp - 1) / p.jp;
  const int threads = (kg * p.parts + 31) / 32 * 32;
  p.threads = threads < 64 ? 64 : threads;
  p.smem = (wsmem ? (size_t)G * p.hp * es : 0) +                // WhT
           2 * (size_t)rows * slot_bytes(G, p.hp, es) +          // slots
           4 * ((size_t)rows * G +                               // zs
                (size_t)p.parts * rows * p.hp +                  // part
                (size_t)rows * H);                               // dcs
  return p;
}

// Rows per block and where WhT lives, the first plan that fits: 4 rows
// (128 blocks at B=256, one per SM) with WhT in shared memory, then in L2;
// 1 row for larger H (> ~650). rows = 0: nothing fits.
ChainPlan choose_chain(int H, int es) {
  const int plans[3][2] = {{4, 1}, {4, 0}, {1, 0}};
  for (const auto& pl : plans) {
    const ChainPlan p = chain_plan(H, pl[1] != 0, pl[0], es);
    if (p.smem <= SMEM_MAX && p.threads <= CHAIN_THREADS) return p;
  }
  ChainPlan none = {};
  return none;
}

// E: the element type of cell, gy, WhT and dz (the gates are f32).
template <int ROWS, bool VEC, bool WSMEM, class E>
__global__ void __launch_bounds__(CHAIN_THREADS)
    bwd_chain_kernel(const int32_t* __restrict__ lengths,
                     const float* __restrict__ gates,
                     const E* __restrict__ cell, const E* __restrict__ gy,
                     const E* __restrict__ whT, E* __restrict__ dz, int B,
                     int T, int H, int parts, int jp) {
  extern __shared__ __align__(16) unsigned char smc[];
  __shared__ int lens[ROWS];
  constexpr int ES = (int)sizeof(E);
  const int G = 4 * H, hp = (H + 3) / 4 * 4, kg = hp / 4;
  const int SB = slot_bytes(G, hp, ES);
  const int dir = blockIdx.y;
  const int b0 = blockIdx.x * ROWS;
  const int tid = threadIdx.x, nt = blockDim.x;
  whT += (size_t)dir * G * hp;
  E* whs = reinterpret_cast<E*>(smc);                       // [G, hp]
  unsigned char* slots =
      smc + (WSMEM ? (size_t)G * hp * ES : 0);               // [2][ROWS]
  float* zs = reinterpret_cast<float*>(slots + 2 * ROWS * SB);  // [ROWS, G]
  float* part = zs + ROWS * G;                        // [parts][ROWS, hp]
  float* dcs = part + parts * ROWS * hp;              // [ROWS, H]

  if (tid < ROWS) {
    const int b = b0 + tid;
    int L = 0;
    if (b < B) L = lengths ? lengths[b] : T;
    lens[tid] = min(max(L, 0), T);
  }
  if (WSMEM) {
    for (int c = tid; c < G * hp * ES / 16; c += nt)
      cp_async16(reinterpret_cast<unsigned char*>(whs) + 16 * c,
                 reinterpret_cast<const unsigned char*>(whT) + 16 * c, true);
    cp_async_commit();
  }
  for (int i = tid; i < ROWS * G; i += nt) zs[i] = 0.0f;
  for (int i = tid; i < ROWS * H; i += nt) dcs[i] = 0.0f;
  __syncthreads();
  int lmax = 0;
  for (int r = 0; r < ROWS; ++r) lmax = max(lmax, lens[r]);

  // Padded frames: dz exactly 0.
  for (int r = 0; r < ROWS && b0 + r < B; ++r) {
    const int L = lens[r];
    E* row = dz + ((size_t)(b0 + r) * T * 2 + dir) * G;
    for (int i = tid; i < (T - L) * G; i += nt) {
      const int t = L + i / G;
      row[(size_t)t * 2 * G + (i - (t - L) * G)] = from_f<E>(0.0f);
    }
  }

  // Copy chain step s's inputs of every active row into slot s % 2: the
  // gates, then cell, c_prev (cell one frame back in chain order, 0 at
  // s = 0) and gy of its frame.
  auto prefetch = [&](int s) {
    unsigned char* slot = slots + (s & 1) * ROWS * SB;
    for (int r = 0; r < ROWS; ++r) {
      const int L = lens[r];
      if (s >= L) continue;
      const int b = b0 + r, t = dir == 0 ? s : L - 1 - s;
      const size_t f = ((size_t)b * T + t) * 2 + dir;
      const size_t fp = s > 0 ? f + (dir == 0 ? -2 : 2) : f;
      float* dg = reinterpret_cast<float*>(slot + r * SB);
      E* de = reinterpret_cast<E*>(dg + G);
      for (int c = tid; c < G / 4; c += nt)
        cp_async16(dg + 4 * c, gates + f * G + 4 * c, true);
      const E* srcs[3] = {cell + f * H, cell + fp * H,
                          gy + ((size_t)b * T + t) * 2 * H + dir * H};
      if (VEC) {
        // 4 elements a copy: 16 bytes (f32) or 8 (bf16).
        for (int c = tid; c < 3 * (H / 4); c += nt) {
          const int seg = c / (H / 4), k = 4 * (c - seg * (H / 4));
          const bool ok = seg != 1 || s > 0;
          if constexpr (ES == 4)
            cp_async16(de + seg * hp + k, srcs[seg] + k, ok);
          else
            cp_async8(de + seg * hp + k, srcs[seg] + k, ok);
        }
      } else {
        for (int c = tid; c < 3 * H; c += nt) {
          const int seg = c / H, k = c - seg * H;
          const bool ok = seg != 1 || s > 0;
          if constexpr (ES == 4)
            cp_async4(de + seg * hp + k, srcs[seg] + k, ok);
          else  // no 2-byte cp.async: an ordinary load and store
            de[seg * hp + k] = ok ? srcs[seg][k] : from_f<E>(0.0f);
        }
      }
    }
    cp_async_commit();
  };

  if (lmax > 0) prefetch(lmax - 1);
  cp_async_wait<0>();
  __syncthreads();

  const int pk = tid % kg, pp = tid / kg;  // phase B: units 4pk.., range pp
  const int jb = pp * jp, je = min(G, jb + jp);
  for (int s = lmax - 1; s >= 0; --s) {
    if (s > 0) prefetch(s - 1);
    // Phase A: dh, dc, dz and the Dc carry for every active (row, unit).
    const unsigned char* slot = slots + (s & 1) * ROWS * SB;
    for (int i = tid; i < ROWS * H; i += nt) {
      const int r = i / H;
      const int k = i - r * H;
      const int L = lens[r];
      if (s < L) {
        const float* in = reinterpret_cast<const float*>(slot + r * SB);
        const E* ine = reinterpret_cast<const E*>(in + G);
        const float gi = in[k], gf = in[H + k], go = in[2 * H + k],
                    ci = in[3 * H + k];
        const float c = to_f(ine[k]), cp = to_f(ine[hp + k]);
        float Dh = 0.0f;
        if (s < L - 1)
          for (int q = 0; q < parts; ++q) Dh += part[(q * ROWS + r) * hp + k];
        const float dh = to_f(ine[2 * hp + k]) + Dh;
        const float tc = tanhf(c);
        const float dc = dcs[i] + dh * go * (1.0f - tc * tc);
        // dz as stored and as Dh's operand (rounded to bf16 in that mode).
        const float d0 = operand<E>(dc * ci * gi * (1.0f - gi));
        const float d1 = operand<E>(dc * cp * gf * (1.0f - gf));
        const float d2 = operand<E>(dh * tc * go * (1.0f - go));
        const float d3 = operand<E>(dc * gi * (1.0f - ci * ci));
        float* z = zs + r * G;
        z[k] = d0;
        z[H + k] = d1;
        z[2 * H + k] = d2;
        z[3 * H + k] = d3;
        const int t = dir == 0 ? s : L - 1 - s;
        E* out = dz + (((size_t)(b0 + r) * T + t) * 2 + dir) * G;
        out[k] = from_f<E>(d0);
        out[H + k] = from_f<E>(d1);
        out[2 * H + k] = from_f<E>(d2);
        out[3 * H + k] = from_f<E>(d3);
        dcs[i] = dc * gf;
      }
    }
    __syncthreads();
    // Phase B: partial Dh[r, 4pk..4pk+3] over dz columns [jb, je).
    if (pp < parts) {
      float acc[ROWS][4];
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
        acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.0f;
      const E* w = (WSMEM ? whs : whT) + 4 * pk;
#pragma unroll 2
      for (int j = jb; j < je; j += 4) {
        float4 z[ROWS];
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
          z[r] = *reinterpret_cast<const float4*>(zs + r * G + j);
        float4 wv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) wv[q] = ld4(w + (size_t)(j + q) * hp);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const float zq[4] = {z[r].x, z[r].y, z[r].z, z[r].w};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            acc[r][0] = fmaf(zq[q], wv[q].x, acc[r][0]);
            acc[r][1] = fmaf(zq[q], wv[q].y, acc[r][1]);
            acc[r][2] = fmaf(zq[q], wv[q].z, acc[r][2]);
            acc[r][3] = fmaf(zq[q], wv[q].w, acc[r][3]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
        *reinterpret_cast<float4*>(part + (pp * ROWS + r) * hp + 4 * pk) =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    }
    cp_async_wait<0>();
    __syncthreads();
  }
}

template <int ROWS, bool VEC, bool WSMEM, class E>
cudaError_t launch_chain(const ChainPlan& p, const int32_t* lengths,
                         const float* gates, const E* cell, const E* gy,
                         const E* whT, E* dz, int B, int T, int H,
                         cudaStream_t st) {
  auto kern = bwd_chain_kernel<ROWS, VEC, WSMEM, E>;
  if (p.smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((B + ROWS - 1) / ROWS, 2);
  kern<<<grid, p.threads, p.smem, st>>>(lengths, gates, cell, gy, whT, dz, B,
                                        T, H, p.parts, p.jp);
  return cudaGetLastError();
}

// The chain of either precision: the plan for H, then the kernel instance
// of its rows, of where WhT lives and of whether the streams go by 4
// elements (H a multiple of 4, cell and gy aligned for it).
template <class E>
int chain(const int32_t* lengths, const float* gates, const E* cell,
          const E* gy, const E* whT, E* dz, int B, int T, int H,
          void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const ChainPlan p = choose_chain(H, (int)sizeof(E));
  if (p.rows == 0) return (int)cudaErrorInvalidValue;
  if (!aligned16(gates) || !aligned16(whT))
    return (int)cudaErrorMisalignedAddress;
  const uintptr_t al = 4 * sizeof(E) - 1;
  const bool vec = H % 4 == 0 && ((uintptr_t)cell & al) == 0 &&
                   ((uintptr_t)gy & al) == 0;
#define CLSTM_CHAIN(R, W)                                                   \
  (vec ? launch_chain<R, true, W, E>(p, lengths, gates, cell, gy, whT, dz, \
                                     B, T, H, st)                          \
       : launch_chain<R, false, W, E>(p, lengths, gates, cell, gy, whT,    \
                                      dz, B, T, H, st))
  const cudaError_t e = p.wsmem       ? CLSTM_CHAIN(4, true)
                        : p.rows == 4 ? CLSTM_CHAIN(4, false)
                                      : CLSTM_CHAIN(1, false);
#undef CLSTM_CHAIN
  return (int)e;
}

// Frame ranges of the dW sum: enough blocks for ~8 per SM on 132 SMs, at
// least 2,048 frames per range, at most 64 ranges.
constexpr int FILL_BLOCKS = 8 * 132;

int dw_tiles(int D, int H) {
  return ((D + 1 + H + DW_BM - 1) / DW_BM) * ((4 * H + DW_BN - 1) / DW_BN);
}

template <bool VEC>
cudaError_t launch_dw(const float* x, const float* y, const float* dz,
                      float* part, int B, int T, int D, int H, int nsplit,
                      int chunk, cudaStream_t st) {
  auto kern = bwd_dw_partial_kernel<VEC>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)DW_SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid(dw_tiles(D, H), 2 * nsplit);
  kern<<<grid, RED_THREADS, DW_SMEM, st>>>(x, y, dz, part, B, T, D, H, nsplit,
                                           chunk);
  return cudaGetLastError();
}

cudaError_t launch_dx(const float* dz, const float* wx, float* whi,
                      float* wlo, float* dx, int N, int D, int H,
                      cudaStream_t st) {
  const int total = 2 * D * 4 * H;
  bwd_split_kernel<<<(total + 255) / 256, 256, 0, st>>>(wx, whi, wlo, total);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(bwd_dx_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)DXW_SMEM);
  if (e != cudaSuccess) return e;
  const unsigned blocks = (unsigned)((D + DXW_BN - 1) / DXW_BN) *
                          (unsigned)((N + DXW_BM - 1) / DXW_BM);
  bwd_dx_kernel<<<blocks, 128 * DXW_WG, DXW_SMEM, st>>>(dz, whi, wlo, dx, N,
                                                        D, H);
  return cudaGetLastError();
}

// Frame ranges the dW sum is split into.
int dw_nsplit(int B, int T, int D, int H) {
  const int N = B * T;
  const int tiles = 2 * dw_tiles(D, H);
  int n = (FILL_BLOCKS + tiles - 1) / tiles;
  const int most = N / 2048;
  if (n > most) n = most;
  if (n > 64) n = 64;
  return n < 1 ? 1 : n;
}

}  // namespace

// Each entry launches on `stream` and returns a cudaError_t (0 on success).
// All pointers are device pointers; `lengths` may be NULL (all T). gates,
// whT, dz and wx must be 16-byte aligned (cudaErrorMisalignedAddress
// otherwise); the others take a slower staging path when they are not.
// B, T, D >= 1, 1 <= H <= 2048 and B·T < 2^31.

// Hp, the padded row length of the WhT the chain takes.
extern "C" int clstm_bidi_lstm_bwd_hp(int H) { return (H + 3) / 4 * 4; }

// dz [B,T,2,4H] from gates [B,T,2,4H], cell [B,T,2,H], gy [B,T,2H] and
// whT [2,4H,Hp] (rows zero-padded from H to Hp = clstm_bidi_lstm_bwd_hp).
extern "C" int clstm_bidi_lstm_bwd_chain(const int32_t* lengths,
                                         const float* gates,
                                         const float* cell, const float* gy,
                                         const float* whT, float* dz, int B,
                                         int T, int H, void* stream) {
  return chain<float>(lengths, gates, cell, gy, whT, dz, B, T, H, stream);
}

// The bf16 mode: cell, gy, whT and dz bf16, the gates f32.
extern "C" int clstm_bidi_lstm_bwd_chain_bf16(const int32_t* lengths,
                                              const float* gates,
                                              const bf16* cell, const bf16* gy,
                                              const bf16* whT, bf16* dz, int B,
                                              int T, int H, void* stream) {
  return chain<bf16>(lengths, gates, cell, gy, whT, dz, B, T, H, stream);
}

// Floats of scratch the reduction takes: the dW partials, nsplit · 2 ·
// (D+1+H) · 4H, then the hi and lo parts of wx for dx, 2 · 2 · D · 4H.
extern "C" long long clstm_bidi_lstm_bwd_scratch(int B, int T, int D, int H) {
  return (long long)dw_nsplit(B, T, D, H) * 2 * (D + 1 + H) * 4 * H +
         4LL * D * 4 * H;
}

// dw [2, D+1+H, 4H] (and dx [B,T,D] unless dx is NULL) from x [B,T,D],
// y [B,T,2H], dz [B,T,2,4H], wx [2,D,4H]; scratch holds
// clstm_bidi_lstm_bwd_scratch(B, T, D, H) floats (16-byte aligned).
extern "C" int clstm_bidi_lstm_bwd_reduce(const float* x, const float* y,
                                          const float* dz, const float* wx,
                                          float* scratch, float* dw, float* dx,
                                          int B, int T, int D, int H,
                                          void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int G = 4 * H, M = D + 1 + H;
  const int N = B * T;
  const int nsplit = dw_nsplit(B, T, D, H);
  const int chunk = (N + nsplit - 1) / nsplit;
  if (!aligned16(dz) || !aligned16(wx) || !aligned16(scratch))
    return (int)cudaErrorMisalignedAddress;
  cudaError_t e =
      (D % 4 == 0 && H % 4 == 0 && aligned16(x) && aligned16(y))
          ? launch_dw<true>(x, y, dz, scratch, B, T, D, H, nsplit, chunk, st)
          : launch_dw<false>(x, y, dz, scratch, B, T, D, H, nsplit, chunk,
                             st);
  if (e != cudaSuccess) return (int)e;
  const int total = 2 * M * G;
  bwd_dw_sum_kernel<<<(total + 255) / 256, 256, 0, st>>>(scratch, dw, nsplit,
                                                         total);
  e = cudaGetLastError();
  if (e != cudaSuccess || dx == nullptr) return (int)e;
  float* whi = scratch + (size_t)nsplit * total;
  return (int)launch_dx(dz, wx, whi, whi + (size_t)2 * D * G, dx, N, D, H,
                        st);
}

// The bf16 mode: x [B,T,D], y [B,T,2H], dz [B,T,2,4H] and wx [2,D,4H]
// bf16, dw f32, dx (unless NULL) bf16 where dx_bf16 is set, else f32;
// scratch as for clstm_bidi_lstm_bwd_reduce. dz and wx 8-byte aligned.
extern "C" int clstm_bidi_lstm_bwd_reduce_bf16(const bf16* x, const bf16* y,
                                               const bf16* dz, const bf16* wx,
                                               float* scratch, float* dw,
                                               void* dx, int B, int T, int D,
                                               int H, int dx_bf16,
                                               void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int G = 4 * H, M = D + 1 + H;
  const int N = B * T;
  const int nsplit = dw_nsplit(B, T, D, H);
  const int chunk = (N + nsplit - 1) / nsplit;
  if (((uintptr_t)dz & 7) || ((uintptr_t)wx & 7) || !aligned16(scratch))
    return (int)cudaErrorMisalignedAddress;
  const bool vec = D % 4 == 0 && H % 4 == 0 && ((uintptr_t)x & 7) == 0 &&
                   ((uintptr_t)y & 7) == 0;
  auto kern = vec ? bwd_dw_partial_bf16_kernel<true>
                  : bwd_dw_partial_bf16_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)DWB_SMEM);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3(dw_tiles(D, H), 2 * nsplit), RED_THREADS, DWB_SMEM, st>>>(
      x, y, dz, scratch, B, T, D, H, nsplit, chunk);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int total = 2 * M * G;
  bwd_dw_sum_kernel<<<(total + 255) / 256, 256, 0, st>>>(scratch, dw, nsplit,
                                                         total);
  e = cudaGetLastError();
  if (e != cudaSuccess || dx == nullptr) return (int)e;
  const unsigned blocks = (unsigned)((D + DXB_BN - 1) / DXB_BN) *
                          (unsigned)((N + DXB_BM - 1) / DXB_BM);
  if (dx_bf16) {
    e = cudaFuncSetAttribute(bwd_dx_bf16_kernel<bf16>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)DXB_SMEM);
    if (e != cudaSuccess) return (int)e;
    bwd_dx_bf16_kernel<bf16><<<blocks, RED_THREADS, DXB_SMEM, st>>>(
        dz, wx, static_cast<bf16*>(dx), N, D, H);
  } else {
    e = cudaFuncSetAttribute(bwd_dx_bf16_kernel<float>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)DXB_SMEM);
    if (e != cudaSuccess) return (int)e;
    bwd_dx_bf16_kernel<float><<<blocks, RED_THREADS, DXB_SMEM, st>>>(
        dz, wx, static_cast<float*>(dx), N, D, H);
  }
  return (int)cudaGetLastError();
}
