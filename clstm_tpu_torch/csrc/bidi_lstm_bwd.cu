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
//   - chain: cell, gy, Wh and dz are bf16, the gates f32 (as K1 stores them
//     in both modes); the math and the Dh and Dc carries stay f32; dz is
//     rounded to bf16 where it is stored and where it enters Dh = dz·Whᵀ,
//     a bf16·bf16 product summed in f32 (pallas_lstm.py L414, L425).
//     What bounds it: the latency of a serial step, not bytes or flops
//     (bound 0.44-0.88 ms at the bench shapes, the chain 3-10 ms). The
//     chain above, instantiated for bf16, read WhT from L2 at every
//     step at H=200 (320 KB a block a step) and ran Dh on the FMA pipes.
//     Here (clstm_bidi_lstm_bwd_chain16, bwd_chain16_kernel) Wh is resident
//     across a thread-block cluster and Dh runs on the bf16 tensor cores:
//       - one direction's chain for a group of R = 16 (or 32) rows runs on
//         a cluster of C CTAs; CTA c owns U units (a multiple of 4 where H
//         is) with their four gate columns, so its gate math, Dc carry and
//         dz stores stay local, and loads its slice of Wh into shared memory
//         once, before the chain;
//       - phase A: a thread takes a quad of 4 units of one row (16- and
//         8-byte accesses of every stream), its inputs loaded a step ahead
//         into registers (and into L2 two steps ahead by prefetch);
//       - Dh = dz·Whᵀ on mma.sync m16n8k16 (bf16, f32 accumulators,
//         ldmatrix fragments; operands zero-padded to k16 and n8; rows of
//         both operands K + 8 elements apart, so an ldmatrix reads 8
//         distinct bank groups); a warp takes a group of n tiles (sharing
//         each A fragment) over one of ks k ranges; even and odd k tiles
//         accumulate apart from zero and are added in f32;
//       - the hand-off, one split cluster barrier a step (buffers by step
//         parity), a reduce-scatter of partial Dh: each CTA multiplies its
//         own dz columns by its rows of Whᵀ into a local stage, then sends
//         each peer the slice of its units, its k ranges summed in order,
//         in 16-byte chunks through mapa + st.shared::cluster; phase A
//         sums the C partials of its units in CTA order;
//       - the next step's loads start after the hand-off, just before
//         the arrive, so that they run while the peers reach the barrier;
//       - the plan (C, R, U, ks) comes from
//         ops/bidi_lstm_kernel.py::chain_plan: one wave of clusters from
//         cudaOccupancyMaxActiveClusters, then the least rows x units a
//         CTA; at B=256 that is C=3 (39 clusters of 3 fit an H100, 30 of
//         4) with 16 rows. Where no cluster holds a slice (H of several
//         hundred, 700, 2048), and where the chain above keeps WhT in
//         shared memory and was the faster on the card (H <= 100 at 16-64
//         frames, as the filter's buckets; H <= 80 at 16 frames or more),
//         the plan's L2 branch runs the chain above, instantiated for bf16
//         (clstm_bidi_lstm_bwd_chain_bf16).
//     On the card (PERF.md §6), in turns with that L2 kernel: 4.1
//     against 10.3 ms at H=200, 2.84 against 3.09 at H=100. A step is then
//     ~7,600 cycles at H=200, each phase a latency chain of its own, run
//     one after another: the product ~2,450, the staged hand-off ~1,600,
//     phase A ~1,300, the barrier's arrive and wait ~1,300
//     (scripts/torch_k2_chain_probe.py --phases).
//     Tried and not kept (slower in turns, or on those phase clocks):
//     writing each partial Dh straight from the accumulators into the
//     peer's shared memory (scattered 4- and 8-byte stores; staging the
//     tile and sending 16-byte chunks of whole rows was faster); one k
//     tile's fragments loaded right before its MMA (asm volatile keeps the
//     order, so each MMA waited for its load); a warp per n tile,
//     re-reading A for each (~480 KB of shared-memory reads a step at
//     H=200); one unit per thread with 4- and 2-byte accesses (~70 memory
//     instructions a thread a step); the next step's loads started before
//     the product; the all-gather hand-off (4-10% slower at every bench
//     shape; an all-gather of dz, each CTA sending its dz block to every
//     peer and multiplying all of dz by its columns of Whᵀ); C=2 (one wave,
//     but 52 and 100 units a CTA), C=4 with 16 rows (two waves) or 32
//     rows, C=1 and C=8.
//   - reduction (clstm_bidi_lstm_bwd_reduce_bf16): x, h_prev (y) and dz are
//     bf16, every product one bf16 pass with f32 accumulation, on wgmma
//     (m64nNk16, N = 64, 128 or 200 by plan) fed by TMA through an mbarrier
//     ring; thread 0 of the block issues the copies, two warpgroups
//     consume. What bounds it: operations at the bf16 tensor cores' peak at
//     bidi2's second layer (4.4e11 flop of dW and 3e11 of dx over its
//     valid frames, 0.75 ms), bytes at the filter's shape; what the design
//     does about it:
//       - one launch stages, per call, x as [x | 1 | 0..] in bf16 (the
//         bias column is data) and y, both to whole 64-column tiles (a box
//         that a row's end cuts is slower), dz at odd H (a TMA box starts
//         on a 16-byte boundary, and the reverse direction's gates start
//         at 4H), and wx for dx in bf16, its rows zero-padded to a multiple
//         of 64;
//       - dW: both operands lie frame-major, so the frames (the product's
//         K) are their slow axis; bf16 wgmma reads shared memory MN-major
//         (the transpose bits), so the slices are taken as they lie, in the
//         128-byte swizzle that TMA writes. A slice is 64 frames, a
//         [B, T, columns] box of tt frames along T by 64/tt rows along B:
//         h_prev is the y box one frame earlier (later in reverse) in each
//         row, and TMA's zero fill gives its zeros at the row ends and
//         zeros past T and B. A block takes two 64-row tiles of
//         [x | 1 | 0..] or h_prev (one per warpgroup), N gate columns, one
//         direction and one frame range; the ranges (slices per range) come
//         from reduce_plan, sized to fill whole waves of the card, each
//         written to its own partial buffer, summed in a fixed order by a
//         second pass: deterministic, no float atomics. Each slice
//         accumulates from zero in the tensor cores and is added to the f32
//         sum with an ordinary add;
//       - dx per direction as a product of dz's rows and the staged wx's
//         rows, both K-major (q contiguous), 128 frames x N columns d per
//         block; each direction's sum rounded to bf16 and the two added in
//         f32 (pallas_lstm.py L913-917), written in x's type.

#include <cuda.h>
#include <cudaTypedefs.h>
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
// Reduction in the bf16 mode: TMA, mbarriers and bf16 wgmma (sm_90a)
// ---------------------------------------------------------------------------

// The raw bits of two bf16 in 32 bits, lo in the low half.
__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  return bits(lo) | (bits(hi) << 16);
}

// Staging: one launch copies up to STAGE_JOBS arrays, each dst [rows, Cp]
// bf16 = src [rows, C] (f32 or bf16) rounded to bf16, the columns past C
// zero except column `one` (when 0 <= one < Cp), which is 1. A thread
// writes 8 columns (16 bytes; Cp is a multiple of 8); job k takes the
// threads [first, first + rows·Cp/8).
struct StageJob {
  const void* src;
  bf16* dst;
  long long rows, first;
  int C, Cp, one, src_f32;
};
constexpr int STAGE_JOBS = 4;
struct StageJobs {
  StageJob job[STAGE_JOBS];
  int n;
  long long total;
};

__global__ void bwd_stage_kernel(const StageJobs js) {
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= js.total) return;
  int k = 0;
  while (k + 1 < js.n && c >= js.job[k + 1].first) ++k;
  const StageJob& jb = js.job[k];
  const int per = jb.Cp / 8;
  const long long r = (c - jb.first) / per;
  const int i0 = (int)(c - jb.first - r * per) * 8;
  uint32_t w[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    bf16 v[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = i0 + 2 * q + h;
      float f = i == jb.one ? 1.0f : 0.0f;
      if (i < jb.C)
        f = jb.src_f32 ? static_cast<const float*>(jb.src)[r * jb.C + i]
                       : to_f(static_cast<const bf16*>(jb.src)[r * jb.C + i]);
      v[h] = from_f<bf16>(f);
    }
    w[q] = pack2(v[0], v[1]);
  }
  *reinterpret_cast<uint4*>(jb.dst + r * jb.Cp + i0) =
      make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void mbar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(b)),
               "r"(count));
}

// One arrival that also expects `bytes` of TMA transactions.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* b, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(b)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(b))
               : "memory");
}

// Wait until the phase of parity `parity` of barrier b has completed. The
// loop is one asm block, so the compiler sees no divergent branch before
// the .aligned wgmma instructions that follow. A wait of more than 2^34
// cycles (seconds) traps: a fault in the ring then ends the launch with
// an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* b, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .u64 t0, t1;\n"
      "mov.u64 t0, %%clock64;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "mov.u64 t1, %%clock64;\n"
      "sub.u64 t1, t1, t0;\n"
      "setp.gt.u64 p, t1, %2;\n"
      "@p trap;\n"
      "bra WAIT;\n"
      "DONE:\n}\n" ::"r"(smem_addr(b)),
      "r"(parity), "l"(1ull << 34)
      : "memory");
}

// A TMA copy of one box of `map` at the given coordinates (innermost
// first) into shared memory, completing on barrier `bar`. Elements outside
// the tensor arrive as zeros.
__device__ __forceinline__ void tma_3d(void* dst, const CUtensorMap* map,
                                       uint64_t* bar, int c0, int c1,
                                       int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map,
                                       uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// wgmma matrix descriptor of a tile in the 128-byte swizzled layout (the
// one TMA writes with CU_TENSOR_MAP_SWIZZLE_128B): rows of 128 bytes, the
// 16-byte chunks of row r XORed with r % 8, 1024-byte atoms of 8 rows.
// LBO (bits 16-29) and SBO (bits 32-45) in 16-byte units; layout type 1
// (bits 62-63) is the 128-byte swizzle.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d (+)= A·B, one m64nNk16 bf16 wgmma with f32 accumulators, A and B by
// descriptor from shared memory; TA, TB: 1 where the operand lies MN-major
// (M or N contiguous), 0 where K-major. scale_d = 0 overwrites d.
// Accumulator layout (warp w of the warpgroup, lane l): d[4c + 2h + e] is
// row 16w + l/4 + 8h, column 8c + 2(l%4) + e.
template <int N, int TA, int TB>
struct Wgmma;

template <int TA, int TB>
struct Wgmma<64, TA, TB> {
  __device__ __forceinline__ static void run(float (&d)[32], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
  }
};

template <int TA, int TB>
struct Wgmma<128, TA, TB> {
  __device__ __forceinline__ static void run(float (&d)[64], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
  }
};

template <int TA, int TB>
struct Wgmma<200, TA, TB> {
  __device__ __forceinline__ static void run(float (&d)[100], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %102, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n200k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99"
        "}, %100, %101, p, 1, 1, %103, %104;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
  }
};

template <int N>
__device__ __forceinline__ void pin_all(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) pin(d[i]);
}

// The bf16 reduction's tiles. A slice is SLICE frames: a box of tt frames
// along T by 64/tt rows along B (tt a power of two), so that the h_prev
// shift stays inside each row and TMA's zero fill gives h_prev = 0 at
// t = 0 (forward) and t = T-1 (reverse), and frames past T or B arrive as
// zeros. An operand tile of a slice is one ATOM: 64 frames x 64 columns
// of bf16, frame-major (128-byte rows), swizzled.
constexpr int SLICE = 64;
constexpr int ATOM = SLICE * 128;
constexpr int R16_THREADS = 256;             // two consumer warpgroups
constexpr int R16_RING = 200 * 1024;         // bytes of a block's ring
constexpr int R16_STAGES_MAX = 8;

// dW: a block takes a pair of 64-row tiles of [x | 1 | 0.. ; h_prev] (one
// per warpgroup; x-part tiles from the staged [x | 1 | 0..], h-part tiles
// from y shifted by one frame) and NW gate columns, for one direction and
// one frame range. A stage is the pair's two A atoms and the NB atoms of
// dz's columns [j0, j0 + 64 NB).
template <int NW>
struct Dw16 {
  static constexpr int NB = (NW + 63) / 64;
  static constexpr int STAGE = (2 + NB) * ATOM;
  static constexpr int STAGES = R16_RING / STAGE < R16_STAGES_MAX
                                    ? R16_RING / STAGE
                                    : R16_STAGES_MAX;
  static constexpr int SMEM = STAGES * STAGE + 1024;  // + alignment slack
};

struct Dw16Args {
  float* out;      // partials [ranges][2][M][G]; dw itself when ranges == 1
  int D, H, M, G;  // M = D + 1 + H rows, G = 4H columns of dW
  int y1;          // y's column of the reverse direction's first unit
  int z1;          // dz's column of the reverse direction's first gate
  int tt, bb;      // a slice: tt frames along T x bb rows along B
  int ntb;         // slices along T
  int S, spr;      // slices in all, slices per frame range
  int nx, nm;      // x-part tiles (of D + 1 rows), all row tiles
  int ntn;         // gate-column tiles
};

// Block (pair * ntn + column tile, 2 * range + dir). Thread 0 is also the
// producer: it issues the TMA copies of slice k + STAGES - 1 into the slot
// of slice k - 1 once both warpgroups have released it (the empty
// barrier's 8 warp arrivals). Both operands lie frame-major, MN-major for
// the wgmma: A's M (rows of dW) and B's N (gate columns) are contiguous,
// the frames (K) are the slow axis: the transpose bits take them as they
// lie. Each slice (4 k16 steps) accumulates from zero in the tensor cores
// and is added to the f32 sum with an ordinary add (the tensor cores do
// not round to nearest when they accumulate). The NW columns of a tile
// never exceed 200, so the sum and the slice's partial fit in registers.
template <int NW>
__global__ void __launch_bounds__(R16_THREADS, 1)
    bwd_dw_bf16_kernel(const __grid_constant__ CUtensorMap xmap,
                       const __grid_constant__ CUtensorMap ymap,
                       const __grid_constant__ CUtensorMap zmap,
                       const Dw16Args a) {
  using C = Dw16<NW>;
  extern __shared__ unsigned char smraw[];
  __shared__ __align__(8) uint64_t full[C::STAGES], empty[C::STAGES];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      ((uintptr_t)smraw + 1023) & ~(uintptr_t)1023);
  const int pair = blockIdx.x / a.ntn, nt = blockIdx.x - pair * a.ntn;
  const int dir = blockIdx.y & 1, range = blockIdx.y >> 1;
  const int s0 = range * a.spr;
  const int ns = min(a.S, s0 + a.spr) - s0;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int m0 = 2 * pair;
  const int ntile = min(2, a.nm - m0);
  const int j0 = nt * NW;
  const uint32_t bytes = (uint32_t)(ntile + C::NB) * ATOM;

  if (tid == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], R16_THREADS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto issue = [&](int k, int slot) {
    const int g = s0 + k;
    const int b0 = (g / a.ntb) * a.bb, t0 = (g % a.ntb) * a.tt;
    unsigned char* st = ring + slot * C::STAGE;
    mbar_expect_tx(&full[slot], bytes);
    for (int w = 0; w < ntile; ++w) {
      const int m = m0 + w;
      if (m < a.nx)
        tma_3d(st + w * ATOM, &xmap, &full[slot], 64 * m, t0, b0);
      else
        tma_3d(st + w * ATOM, &ymap, &full[slot],
               (dir ? a.y1 : 0) + 64 * (m - a.nx), dir ? t0 + 1 : t0 - 1,
               b0);
    }
    for (int c = 0; c < C::NB; ++c)
      tma_3d(st + (2 + c) * ATOM, &zmap, &full[slot],
             dir * a.z1 + j0 + 64 * c, t0, b0);
  };
  if (tid == 0)
    for (int k = 0; k < ns && k < C::STAGES; ++k) issue(k, k);

  float acc[NW / 2], tmp[NW / 2];
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) acc[i] = tmp[i] = 0.0f;
  const bool active = wg < ntile;
  for (int k = 0; k < ns; ++k) {
    const int slot = k % C::STAGES;
    mbar_wait(&full[slot], (k / C::STAGES) & 1);
    __syncwarp();
    if (active) {
      unsigned char* st = ring + slot * C::STAGE;
      const uint32_t sa = smem_addr(st + wg * ATOM);
      const uint32_t sb = smem_addr(st + 2 * ATOM);
      pin_all(tmp);
      wgmma_fence();
      // k16 step kk: frames 16kk.., two 8-row groups (2048 bytes) on;
      // LBO steps between 64-column atoms, SBO between 8-frame groups.
#pragma unroll
      for (int kk = 0; kk < SLICE / 16; ++kk)
        Wgmma<NW, 1, 1>::run(tmp, sw128_desc(sa + 2048 * kk, ATOM, 1024),
                             sw128_desc(sb + 2048 * kk, ATOM, 1024), kk);
      wgmma_commit();
      wgmma_wait0();
      pin_all(tmp);
#pragma unroll
      for (int i = 0; i < NW / 2; ++i) acc[i] += tmp[i];
    }
    __syncwarp();
    if ((tid & 31) == 0) mbar_arrive(&empty[slot]);
    // Warp 0 refills as a whole (its lanes wait together; lane 0 issues),
    // so no lane of a warpgroup diverges around the wgmma.
    if (tid < 32 && k >= 1 && k - 1 + C::STAGES < ns) {
      const int ps = (k - 1) % C::STAGES;
      mbar_wait(&empty[ps], ((k - 1) / C::STAGES) & 1);
      if (tid == 0) issue(k - 1 + C::STAGES, ps);
      __syncwarp();
    }
  }
  if (!active) return;

  // Tile rows -> dW rows: the x-part's rows 0..D are dWx and the bias row
  // (the staged ones column is column D), h-part row k is dW row D+1+k.
  const int m = m0 + wg, w = (tid >> 5) & 3, l = tid & 31;
  float* out = a.out + ((size_t)range * 2 + dir) * a.M * a.G;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rl = 16 * w + (l >> 2) + 8 * h;
    int row;
    if (m < a.nx) {
      row = 64 * m + rl;
      if (row > a.D) continue;
    } else {
      const int k = 64 * (m - a.nx) + rl;
      if (k >= a.H) continue;
      row = a.D + 1 + k;
    }
    float* o = out + (size_t)row * a.G;
#pragma unroll
    for (int c = 0; c < NW / 8; ++c) {
      const int j = j0 + 8 * c + 2 * (l & 3);  // G is even: j + 1 < G too
      if (j < a.G)
        *reinterpret_cast<float2*>(o + j) =
            make_float2(acc[4 * c + 2 * h], acc[4 * c + 2 * h + 1]);
    }
  }
}

// dx: a block takes 128 frames (64 per warpgroup) and NW columns d, and
// runs over q (the 4H dz columns) of the forward direction, then of the
// reverse: a stage is each warpgroup's dz atom (64 frames x 64 q) and the
// NW rows d of the staged wx (64 q each). Both operands lie K-major (q
// contiguous), the wgmma's default. After the forward direction its sum is
// rounded to bf16 and kept packed; the reverse direction's sum is rounded
// too, the two added in f32 and written in x's type (pallas_lstm.py
// L455-461, L913-917). No float atomics: each dx value is one thread's.
template <int NW>
struct Dx16 {
  static constexpr int WB = (NW * 128 + 1023) / 1024 * 1024;
  static constexpr int STAGE = 2 * ATOM + WB;
  static constexpr int STAGES = R16_RING / STAGE < R16_STAGES_MAX
                                    ? R16_RING / STAGE
                                    : R16_STAGES_MAX;
  static constexpr int SMEM = STAGES * STAGE + 1024;
};

struct Dx16Args {
  void* dx;       // [N, D], bf16 where out_bf16, else f32
  int N, D;
  int z1;         // dz's column of the reverse direction's first gate
  int KQ;         // q slices (of 64) per direction: Gp / 64
  int ntd;        // column tiles
  int out_bf16;
};

template <int NW>
__global__ void __launch_bounds__(R16_THREADS, 1)
    bwd_dx_bf16_kernel(const __grid_constant__ CUtensorMap zmap,
                       const __grid_constant__ CUtensorMap wmap,
                       const Dx16Args a) {
  using C = Dx16<NW>;
  extern __shared__ unsigned char smraw[];
  __shared__ __align__(8) uint64_t full[C::STAGES], empty[C::STAGES];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      ((uintptr_t)smraw + 1023) & ~(uintptr_t)1023);
  const int ft = blockIdx.x / a.ntd, dt = blockIdx.x - ft * a.ntd;
  const int n0 = ft * 128, d0 = dt * NW;
  const int ns = 2 * a.KQ;
  const int tid = threadIdx.x, wg = tid >> 7;
  const uint32_t bytes = 2 * ATOM + NW * 128;

  if (tid == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], R16_THREADS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto issue = [&](int k, int slot) {
    const int dir = k / a.KQ, q0 = (k - dir * a.KQ) * 64;
    unsigned char* st = ring + slot * C::STAGE;
    mbar_expect_tx(&full[slot], bytes);
    tma_2d(st, &zmap, &full[slot], dir * a.z1 + q0, n0);
    tma_2d(st + ATOM, &zmap, &full[slot], dir * a.z1 + q0, n0 + 64);
    tma_2d(st + 2 * ATOM, &wmap, &full[slot], q0, dir * a.D + d0);
  };
  if (tid == 0)
    for (int k = 0; k < ns && k < C::STAGES; ++k) issue(k, k);

  float acc[NW / 2];
  uint32_t fwd[NW / 4];  // the forward direction's sum, bf16 pairs
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) acc[i] = 0.0f;
  for (int k = 0; k < ns; ++k) {
    const int slot = k % C::STAGES;
    mbar_wait(&full[slot], (k / C::STAGES) & 1);
    __syncwarp();
    if (k == a.KQ) {
#pragma unroll
      for (int i = 0; i < NW / 4; ++i)
        fwd[i] = pack2(from_f<bf16>(acc[2 * i]), from_f<bf16>(acc[2 * i + 1]));
    }
    unsigned char* st = ring + slot * C::STAGE;
    const uint32_t sa = smem_addr(st + wg * ATOM);
    const uint32_t sb = smem_addr(st + 2 * ATOM);
    const int first = k % a.KQ == 0;
    pin_all(acc);
    wgmma_fence();
    // k16 step kk: 32 bytes on inside the 128-byte swizzled rows; SBO
    // steps between 8-row groups.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      Wgmma<NW, 0, 0>::run(acc, sw128_desc(sa + 32 * kk, 16, 1024),
                           sw128_desc(sb + 32 * kk, 16, 1024),
                           !(first && kk == 0));
    wgmma_commit();
    wgmma_wait0();
    pin_all(acc);
    __syncwarp();
    if ((tid & 31) == 0) mbar_arrive(&empty[slot]);
    // Warp 0 refills as a whole (its lanes wait together; lane 0 issues),
    // so no lane of a warpgroup diverges around the wgmma.
    if (tid < 32 && k >= 1 && k - 1 + C::STAGES < ns) {
      const int ps = (k - 1) % C::STAGES;
      mbar_wait(&empty[ps], ((k - 1) / C::STAGES) & 1);
      if (tid == 0) issue(k - 1 + C::STAGES, ps);
      __syncwarp();
    }
  }

  const int w = (tid >> 5) & 3, l = tid & 31;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = n0 + 64 * wg + 16 * w + (l >> 2) + 8 * h;
    if (n >= a.N) continue;
#pragma unroll
    for (int c = 0; c < NW / 8; ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * c + 2 * h + e;
        const int d = d0 + 8 * c + 2 * (l & 3) + e;
        if (d >= a.D) continue;
        const uint32_t f = fwd[i >> 1];
        const float v = (e ? hi_f(f) : lo_f(f)) + operand<bf16>(acc[i]);
        const size_t o = (size_t)n * a.D + d;
        if (a.out_bf16)
          static_cast<bf16*>(a.dx)[o] = from_f<bf16>(v);
        else
          static_cast<float*>(a.dx)[o] = v;
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

// ---------------------------------------------------------------------------
// The bf16 chain on a thread-block cluster (chain16)
// ---------------------------------------------------------------------------

// Rows of an m16 tile, threads of a CTA, and units of a row a thread takes
// in phase A (a quad: one per thread, so rows x ceil(units / CH_Q) <=
// CH_THREADS).
constexpr int CH_M = 16;
constexpr int CH_THREADS = 512;
constexpr int CH_Q = 4;
// Dynamic shared memory a CTA may use, less the static row lengths.
constexpr int CH_SMEM_MAX = 232448 - 4 * 2 * CH_M;

__host__ __device__ inline int up_to(int v, int m) {
  return (v + m - 1) / m * m;
}

// Where a CTA's operands live in its shared memory
// (ops/bidi_lstm_kernel.py::chain_smem counts the same): B = its WhT rows
// [N = H up to 8][K = 4U up to 16] (its dz columns g·U + u against every
// unit), A = its dz [R][K], stage = its product's partials of ks k ranges
// [ks][R][N] f32, part = the partial Dh its peers send it
// [2 parities][C][R][U] f32.
// Rows of A and B are K + 8 elements apart: an odd multiple of 16 bytes,
// so the 8 rows an ldmatrix reads fall in 8 different bank groups.
struct Geo16 {
  int K, N, ld;
  long long off_a, off_stage, off_part, bytes;
};

__host__ __device__ inline Geo16 geo16(int H, int C, int U, int R, int ks) {
  Geo16 g;
  g.K = up_to(4 * U, 16);
  g.N = up_to(H, 8);
  g.ld = g.K + 8;
  const long long a = (long long)R * g.ld * 2;
  const long long stage = (long long)ks * R * g.N * 4;
  const long long part = 2LL * C * R * U * 4;
  g.off_a = (long long)g.N * g.ld * 2;  // a multiple of 16
  g.off_stage = g.off_a + a;
  g.off_part = g.off_stage + stage;
  g.bytes = g.off_part + part;
  return g;
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The address of `local` in the shared memory of the cluster's CTA `rank`.
__device__ __forceinline__ uint32_t peer_addr(const void* local,
                                              uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_addr(local)), "r"(rank));
  return remote;
}

__device__ __forceinline__ void st_peer(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(addr), "f"(v)
               : "memory");
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

__device__ __forceinline__ void st_peer16(uint32_t addr, uint4 v) {
  asm volatile("st.shared::cluster.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   addr),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
               "[%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t addr, uint32_t (&r)[2]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr)
               : "memory");
}

// c += a·b, m16n8k16, bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// n tiles a warp multiplies by each A fragment it loads: A (dz) is read
// from shared memory once per group of them, not once per n tile (the
// product is bound by shared-memory reads: every weight is used for only
// R rows a step). 4 with one m tile, 2 with two (registers).
__host__ __device__ constexpr int ch_ng(int mt) { return 4 / mt; }

// acc[j][m] = Σ over the k tiles [kt0, kt1) of A[m-th 16 rows][k tile] ·
// B[n tile nt0 + j][k tile]ᵀ for j < nn (<= NG), A [MT·16][ld] and B
// [N][ld] bf16 in shared memory, k contiguous. The fragments of two k tiles
// are loaded first and then multiplied (asm volatile keeps the order as
// written, so a load placed after an MMA would wait for it); even and odd
// k tiles go to two accumulators, added in that order at the end.
// acc[j][m][0..1]: row lane/4, columns 2(lane%4) and +1 of the tile;
// [2..3]: row lane/4 + 8.
template <int MT, int NG>
__device__ __forceinline__ void dh_tiles(const bf16* A, const bf16* Bm,
                                         int ld, int nt0, int nn, int kt0,
                                         int kt1, float (&acc)[NG][MT][4]) {
  const int lane = threadIdx.x & 31;
  float c[2][NG][MT][4];
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int j = 0; j < NG; ++j)
#pragma unroll
      for (int m = 0; m < MT; ++m)
        c[p][j][m][0] = c[p][j][m][1] = c[p][j][m][2] = c[p][j][m][3] = 0.0f;
  const uint32_t a0 = smem_addr(A + (lane & 15) * ld + (lane >> 4) * 8);
  const uint32_t b0 =
      smem_addr(Bm + (nt0 * 8 + (lane & 7)) * ld + ((lane >> 3) & 1) * 8);
  const uint32_t nstep = 2 * 8 * ld, mstep = 2 * CH_M * ld;
  int kt = kt0;
  for (; kt + 2 <= kt1; kt += 2) {
    uint32_t a[2][MT][4], b[2][NG][2];
#pragma unroll
    for (int p = 0; p < 2; ++p) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
        ldsm_x4(a0 + m * mstep + 32 * (kt + p), a[p][m]);
#pragma unroll
      for (int j = 0; j < NG; ++j)
        if (j < nn) ldsm_x2(b0 + j * nstep + 32 * (kt + p), b[p][j]);
    }
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int j = 0; j < NG; ++j)
        if (j < nn)
#pragma unroll
          for (int m = 0; m < MT; ++m) mma_bf16(c[p][j][m], a[p][m], b[p][j]);
  }
  if (kt < kt1) {
    uint32_t a[MT][4], b[NG][2];
#pragma unroll
    for (int m = 0; m < MT; ++m) ldsm_x4(a0 + m * mstep + 32 * kt, a[m]);
#pragma unroll
    for (int j = 0; j < NG; ++j)
      if (j < nn) ldsm_x2(b0 + j * nstep + 32 * kt, b[j]);
#pragma unroll
    for (int j = 0; j < NG; ++j)
      if (j < nn)
#pragma unroll
        for (int m = 0; m < MT; ++m) mma_bf16(c[0][j][m], a[m], b[j]);
  }
#pragma unroll
  for (int j = 0; j < NG; ++j)
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][m][i] = c[0][j][m][i] + c[1][j][m][i];
}

// One direction's chain for a group of R = 16·MT rows on a cluster of C
// CTAs (grid: C · row groups along x, 2 directions along y). CTA c owns
// units [c·U, c·U + nu) with their four gate columns. VEC: H and U are
// multiples of 4, so every quad of units is whole and aligned for vector
// accesses (the instance without the scalar paths is ~30% shorter, and the
// step's code stays in the instruction caches). wh: Wh [2][H][4H] in bf16
// (the B operand is Wh itself: Dh = dz·Whᵀ).
template <int MT, bool VEC>
__global__ void __launch_bounds__(CH_THREADS, 1)
    bwd_chain16_kernel(const int32_t* __restrict__ lengths,
                       const float* __restrict__ gates,
                       const bf16* __restrict__ cell,
                       const bf16* __restrict__ gy,
                       const bf16* __restrict__ wh, bf16* __restrict__ dz,
                       int B, int T, int H, int U, int ks) {
  constexpr int R = CH_M * MT;
  extern __shared__ __align__(128) unsigned char smc[];
  __shared__ int lens[2 * CH_M];
  const int C = (int)cluster_size();
  const int crank = (int)cluster_rank();
  const int dir = blockIdx.y;
  const int b0 = (blockIdx.x / C) * R;
  const int k0 = crank * U;
  const int nu = max(0, min(U, H - k0));
  const int G = 4 * H;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid >> 5, nwarp = nt >> 5, lane = tid & 31;
  const Geo16 geo = geo16(H, C, U, R, ks);
  const int ld = geo.ld, K = geo.K, N = geo.N;
  bf16* Bs = reinterpret_cast<bf16*>(smc);
  bf16* As = reinterpret_cast<bf16*>(smc + geo.off_a);
  float* stage = reinterpret_cast<float*>(smc + geo.off_stage);
  float* part = reinterpret_cast<float*>(smc + geo.off_part);
  wh += (size_t)dir * H * G;

  if (tid < R) {
    const int b = b0 + tid;
    int L = 0;
    if (b < B) L = lengths ? lengths[b] : T;
    lens[tid] = min(max(L, 0), T);
  }
  // The B slice, zero where no unit or dz column is: loaded once.
  for (int i = tid; i < N * K; i += nt) {
    const int n = i / K, j = i - n * K;
    const int g = j / U, u = j - g * U;
    bf16 v = from_f<bf16>(0.0f);
    if (n < H && g < 4 && u < nu) v = wh[(size_t)n * G + g * H + k0 + u];
    Bs[(size_t)n * ld + j] = v;
  }
  for (int i = tid; i < R * ld; i += nt) As[i] = from_f<bf16>(0.0f);
  for (int i = tid; i < 2 * C * R * U; i += nt) part[i] = 0.0f;
  __syncthreads();
  int lmax = 0;
  for (int r = 0; r < R; ++r) lmax = max(lmax, lens[r]);

  // Padded frames of this CTA's units: dz exactly 0.
  for (int r = 0; r < R && b0 + r < B; ++r) {
    const int L = lens[r];
    for (int i = tid; i < (T - L) * 4 * nu; i += nt) {
      const int t = L + i / (4 * nu), q = i % (4 * nu);
      const int g = q / nu, u = q - g * nu;
      dz[(((size_t)(b0 + r) * T + t) * 2 + dir) * G + g * H + k0 + u] =
          from_f<bf16>(0.0f);
    }
  }
  // Every CTA of the cluster has initialised its buffers before any peer
  // writes into them.
  cluster_arrive();
  cluster_wait();

  // Phase A's item: thread tid takes the quad of units [u0, u0 + 4) of row
  // ir (those below nu), with the step's inputs in registers (loaded a step
  // ahead) and the Dc carry. With VEC every quad is whole and 16-byte (f32)
  // or 8-byte (bf16) aligned in every stream, and is read and written by
  // one vector access each.
  const int nq = (nu + CH_Q - 1) / CH_Q;
  const bool has = tid < R * nq;
  constexpr bool vec = VEC;
  const int ir = has ? tid / nq : 0;
  const int u0 = has ? CH_Q * (tid - ir * nq) : 0;
  const int iL = has ? lens[ir] : 0;
  float in[7][CH_Q], Dc[CH_Q];
#pragma unroll
  for (int e = 0; e < CH_Q; ++e) Dc[e] = 0.0f;
  // The frame of chain step s of the row (valid where s < its length):
  // gi, gf, go, ci, c, c_prev and gy are read there.
  auto frame = [&](int s) {
    const int t = dir == 0 ? s : iL - 1 - s;
    return ((size_t)(b0 + ir) * T + t) * 2 + dir;
  };
  auto ld_bf4 = [&](float* v, const bf16* p) {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    v[0] = lo_f(w.x), v[1] = hi_f(w.x), v[2] = lo_f(w.y), v[3] = hi_f(w.y);
  };
  auto load = [&](int s) {
#pragma unroll
    for (int q = 0; q < 7; ++q)
#pragma unroll
      for (int e = 0; e < CH_Q; ++e) in[q][e] = 0.0f;
    if (s >= iL) return;
    const size_t f = frame(s), fp = dir == 0 ? f - 2 : f + 2;
    const int k = k0 + u0;
    const size_t fy = (f >> 1) * 2 * H + dir * H + k;
    if (vec) {
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(
            gates + f * G + g * H + k));
        in[g][0] = v.x, in[g][1] = v.y, in[g][2] = v.z, in[g][3] = v.w;
      }
      ld_bf4(in[4], cell + f * H + k);
      if (s > 0) ld_bf4(in[5], cell + fp * H + k);
      ld_bf4(in[6], gy + fy);
    } else {
#pragma unroll
      for (int e = 0; e < CH_Q; ++e) {
        if (u0 + e >= nu) break;
#pragma unroll
        for (int g = 0; g < 4; ++g)
          in[g][e] = __ldg(gates + f * G + g * H + k + e);
        in[4][e] = to_f(cell[f * H + k + e]);
        if (s > 0) in[5][e] = to_f(cell[fp * H + k + e]);
        in[6][e] = to_f(gy[fy + e]);
      }
    }
  };
  // The same reads of step s into L2, two steps ahead of their loads.
  auto prefetch = [&](int s) {
    if (s >= iL) return;
    const size_t f = frame(s);
    const int k = k0 + u0;
#pragma unroll
    for (int g = 0; g < 4; ++g) prefetch_l2(gates + f * G + g * H + k);
    prefetch_l2(cell + f * H + k);
    prefetch_l2(gy + (f >> 1) * 2 * H + dir * H + k);
  };
  // The product's n tiles, their groups of NG (a warp's share), k tiles.
  constexpr int NG = ch_ng(MT);
  const int NT = N / 8, NG_T = (NT + NG - 1) / NG, KT = K / 16;

  if (lmax > 0) load(lmax - 1);
  if (lmax > 1) prefetch(lmax - 2);
  for (int s = lmax - 1; s >= 0; --s) {
    const int slot = s & 1;
    if (s >= 2) prefetch(s - 2);
    // Phase A: dh, dc, dz and the Dc carry of the quad where its row is
    // active; Dh is the sum, in a fixed order, of the partials of step
    // s + 1.
    if (s < iL) {
      float Dh[CH_Q] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (s < iL - 1) {
        const float* p = part + ((size_t)((slot ^ 1) * C) * R + ir) * U + u0;
        for (int c = 0; c < C; ++c, p += (size_t)R * U) {
          if (vec) {
            const float4 v = *reinterpret_cast<const float4*>(p);
            Dh[0] += v.x, Dh[1] += v.y, Dh[2] += v.z, Dh[3] += v.w;
          } else {
#pragma unroll
            for (int e = 0; e < CH_Q; ++e)
              if (u0 + e < nu) Dh[e] += p[e];
          }
        }
      }
      // dz as stored and as Dh's operand: rounded to bf16.
      bf16 d[4][CH_Q];
#pragma unroll
      for (int e = 0; e < CH_Q; ++e) {
        const float gi = in[0][e], gf = in[1][e], go = in[2][e],
                    ci = in[3][e], c = in[4][e], cp = in[5][e];
        const float dh = in[6][e] + Dh[e];
        const float tc = tanhf(c);
        const float dc = Dc[e] + dh * go * (1.0f - tc * tc);
        d[0][e] = from_f<bf16>(dc * ci * gi * (1.0f - gi));
        d[1][e] = from_f<bf16>(dc * cp * gf * (1.0f - gf));
        d[2][e] = from_f<bf16>(dh * tc * go * (1.0f - go));
        d[3][e] = from_f<bf16>(dc * gi * (1.0f - ci * ci));
        Dc[e] = dc * gf;
      }
      bf16* a = As + (size_t)ir * ld + u0;
      bf16* out = dz + frame(s) * G + k0 + u0;
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        if (vec) {
          const uint2 w = make_uint2(pack2(d[g][0], d[g][1]),
                                     pack2(d[g][2], d[g][3]));
          *reinterpret_cast<uint2*>(a + g * U) = w;
          *reinterpret_cast<uint2*>(out + (size_t)g * H) = w;
        } else {
#pragma unroll
          for (int e = 0; e < CH_Q; ++e)
            if (u0 + e < nu) {
              a[g * U + e] = d[g][e];
              out[(size_t)g * H + e] = d[g][e];
            }
        }
      }
    }
    if (s == 0) break;
    __syncthreads();
    // Partial Dh of this CTA's dz columns for every unit, each warp a group
    // of NG n tiles over one of ks k ranges, into the stage.
    for (int w = warp; w < NG_T * ks; w += nwarp) {
      const int ng = w % NG_T, q = w / NG_T;
      float acc[NG][MT][4];
      dh_tiles<MT, NG>(As, Bs, ld, ng * NG, min(NG, NT - ng * NG),
                       q * KT / ks, (q + 1) * KT / ks, acc);
#pragma unroll
      for (int j = 0; j < NG; ++j)
        if (ng * NG + j < NT)
#pragma unroll
          for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int h2 = 0; h2 < 2; ++h2) {
              const int r = m * CH_M + (lane >> 2) + 8 * h2;
              const int n = (ng * NG + j) * 8 + 2 * (lane & 3);
              *reinterpret_cast<float2*>(stage + ((size_t)q * R + r) * N +
                                         n) =
                  make_float2(acc[j][m][2 * h2], acc[j][m][2 * h2 + 1]);
            }
    }
    __syncthreads();
    // Each CTA q's slice [R, U_q] of the partial, its k ranges summed in
    // order, into q's part[slot][crank]: 4 units a store (16 bytes, by
    // distributed shared memory to a peer) where U is a multiple of 4,
    // else 1.
    const int w4 = vec ? CH_Q : 1;
    const int per_row = U / w4, per = R * per_row;
    for (int i = tid; i < C * per; i += nt) {
      const int q = i / per, rem = i - q * per;
      const int r = rem / per_row, u = (rem - r * per_row) * w4;
      if (q * U + u >= H) continue;
      const float* src = stage + (size_t)r * N + q * U + u;
      float* dst = part + ((size_t)(slot * C + crank) * R + r) * U + u;
      if (vec) {
        float4 v = *reinterpret_cast<const float4*>(src);
        for (int k = 1; k < ks; ++k) {
          const float4 x =
              *reinterpret_cast<const float4*>(src + (size_t)k * R * N);
          v.x += x.x, v.y += x.y, v.z += x.z, v.w += x.w;
        }
        if (q == crank)
          *reinterpret_cast<float4*>(dst) = v;
        else
          st_peer16(peer_addr(dst, (uint32_t)q),
                    make_uint4(__float_as_uint(v.x), __float_as_uint(v.y),
                               __float_as_uint(v.z), __float_as_uint(v.w)));
      } else {
        float v = src[0];
        for (int k = 1; k < ks; ++k) v += src[(size_t)k * R * N];
        if (q == crank)
          *dst = v;
        else
          st_peer(peer_addr(dst, (uint32_t)q), v);
      }
    }
    // The next step's inputs (in L2 since the prefetch two steps ago),
    // read while the peers reach the barrier.
    load(s - 1);
    cluster_arrive();
    cluster_wait();
  }
  // No CTA leaves while a peer may still address its shared memory.
  cluster_arrive();
  cluster_wait();
}

// A chain16 plan (ops/bidi_lstm_kernel.py::chain_plan), checked: C in
// {1, 2, 3, 4, 8} with every CTA owning at least one unit and all of them
// together every unit, R 16 or 32 rows, a quad of units a thread, ks k
// ranges from 1 to the k tiles, shared memory within a CTA's. Returns its
// bytes of shared memory, 0 if it is not one.
long long plan16(int H, int C, int R, int U, int ks) {
  if (!(C >= 1 && C <= 4) && C != 8) return 0;
  if (!(R == 16 || R == 32) ||
      H < 1 || U < 1 || (long long)C * U < H || (long long)(C - 1) * U >= H ||
      R * ((U + CH_Q - 1) / CH_Q) > CH_THREADS || ks < 1)
    return 0;
  const Geo16 g = geo16(H, C, U, R, ks);
  if (ks > g.K / 16 || g.bytes > CH_SMEM_MAX)
    return 0;
  return g.bytes;
}

using Chain16 = void (*)(const int32_t*, const float*, const bf16*,
                         const bf16*, const bf16*, bf16*, int, int, int, int,
                         int);

// The kernel instance of a plan, with its shared-memory limit set.
cudaError_t chain16_of(int H, int R, int U, long long smem, Chain16* kern) {
  static const Chain16 table[2][2] = {
      {bwd_chain16_kernel<1, false>, bwd_chain16_kernel<1, true>},
      {bwd_chain16_kernel<2, false>, bwd_chain16_kernel<2, true>}};
  const bool vec = H % CH_Q == 0 && U % CH_Q == 0;
  *kern = table[R / CH_M - 1][vec];
  return cudaFuncSetAttribute(*kern,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// A launch of a plan: grid (C · row groups, 2 directions), clusters of C
// CTAs along x.
struct Config16 {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  Config16(int C, unsigned gridx, long long smem, cudaStream_t st) : cfg() {
    cfg.gridDim = dim3(gridx, 2, 1);
    cfg.blockDim = dim3(CH_THREADS, 1, 1);
    cfg.dynamicSmemBytes = (size_t)smem;
    cfg.stream = st;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// The bf16 chain on clusters at a plan: the plan's kernel instance, then
// the launch.
int chain16(const int32_t* lengths, const float* gates, const bf16* cell,
            const bf16* gy, const bf16* wh, bf16* dz, int B, int T, int H,
            int C, int R, int U, int ks, void* stream) {
  const long long smem = plan16(H, C, R, U, ks);
  if (B < 1 || T < 1 || smem == 0) return (int)cudaErrorInvalidValue;
  // The quads' vector accesses (H and U multiples of 4).
  if (!aligned16(gates) || ((uintptr_t)cell & 7) || ((uintptr_t)gy & 7) ||
      ((uintptr_t)dz & 7))
    return (int)cudaErrorMisalignedAddress;
  Chain16 kern;
  cudaError_t e = chain16_of(H, R, U, smem, &kern);
  if (e != cudaSuccess) return (int)e;
  Config16 c(C, (unsigned)(C * ((B + R - 1) / R)), smem,
             (cudaStream_t)stream);
  e = cudaLaunchKernelEx(&c.cfg, kern, lengths, gates, cell, gy, wh, dz, B,
                         T, H, U, ks);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Clusters of a plan the current device holds at once
// (cudaOccupancyMaxActiveClusters), or minus a CUDA error.
int clusters16(int H, int C, int R, int U, int ks) {
  const long long smem = plan16(H, C, R, U, ks);
  if (smem == 0) return -(int)cudaErrorInvalidValue;
  Chain16 kern;
  cudaError_t e = chain16_of(H, R, U, smem, &kern);
  if (e != cudaSuccess) return -(int)e;
  Config16 c(C, (unsigned)C, smem, nullptr);
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, kern, &c.cfg);
  return e == cudaSuccess ? n : -(int)e;
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


// ---------------------------------------------------------------------------
// The bf16 reduction's host side: tensor maps, scratch, launches
// ---------------------------------------------------------------------------

// cuTensorMapEncodeTiled, looked up from the driver through the runtime
// (the library links no libcuda); nullptr if the driver has none.
PFN_cuTensorMapEncodeTiled_v12000 encode_tiled() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// A bf16 map of `rank` dims (dims[0] innermost; strides[i] the bytes
// between steps of dim i + 1) whose boxes land 128-byte swizzled.
bool bf16_map(CUtensorMap* m, const void* base, int rank,
              const uint64_t* dims, const uint64_t* strides,
              const uint32_t* box) {
  const auto enc = encode_tiled();
  const uint32_t ones[3] = {1, 1, 1};
  return enc &&
         enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, (cuuint32_t)rank,
             const_cast<void*>(base), dims, strides, box, ones,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

inline long long round_up(long long v, long long m) {
  return (v + m - 1) / m * m;
}

// The bf16 reduction's shape and plan, and where its staged copies and
// partials lie in the scratch (byte offsets, each 256-aligned). x and y
// are staged to whole 64-column tiles, so that every x and h_prev box lies
// inside its rows: boxes that a row's end cuts were measured 14-28% slower
// in dW (PERF.md §6, PR 13). A TMA box starts on a 16-byte boundary of its
// row: the reverse direction's dz columns (at 4H) do where H is even; at
// odd H dz is staged too, each direction's columns padded to a multiple
// of 8.
struct Red16 {
  int G, M, N;
  int Dp;        // staged x: [x | 1 | 0..] in Dp = roundup(D + 1, 64) columns
  int Hp;        // y staged per direction in Hp = roundup(H, 64) columns
  int Gq;        // dz staged per direction in Gq = roundup(4H, 8) columns
  bool zstage;   // H odd
  int Gp;        // staged wx rows: 4H rounded up to 64
  int bb, ntb, S, ranges;
  int nx, nm, pairs;
  long long off_y, off_z, off_w, off_part, bytes;
};

Red16 red16(int B, int T, int D, int H, int tt, int spr) {
  Red16 r;
  r.G = 4 * H, r.M = D + 1 + H;
  r.N = B * T;
  r.Dp = (int)round_up(D + 1, 64);
  r.Hp = (int)round_up(H, 64);
  r.Gq = (int)round_up(4 * H, 8);
  r.zstage = H % 2 != 0;
  r.Gp = (int)round_up(4 * H, 64);
  r.bb = SLICE / tt;
  r.ntb = (T + tt - 1) / tt;
  r.S = r.ntb * ((B + r.bb - 1) / r.bb);
  r.ranges = (r.S + spr - 1) / spr;
  r.nx = r.Dp / 64;
  r.nm = r.nx + r.Hp / 64;
  r.pairs = (r.nm + 1) / 2;
  long long o = round_up(2LL * r.N * r.Dp, 256);
  r.off_y = o;
  o += round_up(2LL * r.N * 2 * r.Hp, 256);
  r.off_z = o;
  o += r.zstage ? round_up(2LL * r.N * 2 * r.Gq, 256) : 0;
  r.off_w = o;
  o += round_up(2LL * 2 * D * r.Gp, 256);
  r.off_part = o;
  o += r.ranges > 1 ? 4LL * r.ranges * 2 * r.M * r.G : 0;
  r.bytes = o;
  return r;
}

// Add a staging job (dst [rows, Cp] from src [rows, C]) to js.
void add_job(StageJobs& js, const void* src, bool src_f32, bf16* dst,
             long long rows, int C, int Cp, int one) {
  StageJob& j = js.job[js.n++];
  j.src = src, j.dst = dst, j.rows = rows, j.first = js.total;
  j.C = C, j.Cp = Cp, j.one = one, j.src_f32 = src_f32;
  js.total += rows * (Cp / 8);
}

template <int NW>
cudaError_t launch_dw16(const Red16& r, const CUtensorMap& xm,
                        const CUtensorMap& ym, const CUtensorMap& zm,
                        const Dw16Args& a, cudaStream_t st) {
  auto kern = bwd_dw_bf16_kernel<NW>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Dw16<NW>::SMEM);
  if (e != cudaSuccess) return e;
  kern<<<dim3(r.pairs * a.ntn, 2 * r.ranges), R16_THREADS, Dw16<NW>::SMEM,
         st>>>(xm, ym, zm, a);
  return cudaGetLastError();
}

template <int NW>
cudaError_t launch_dx16(const Red16& r, const CUtensorMap& zm,
                        const CUtensorMap& wm, const Dx16Args& a,
                        cudaStream_t st) {
  auto kern = bwd_dx_bf16_kernel<NW>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Dx16<NW>::SMEM);
  if (e != cudaSuccess) return e;
  kern<<<(unsigned)((r.N + 127) / 128) * a.ntd, R16_THREADS, Dx16<NW>::SMEM,
         st>>>(zm, wm, a);
  return cudaGetLastError();
}

bool valid_nw(int nw) { return nw == 64 || nw == 128 || nw == 200; }

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

// The bf16 chain on a thread-block cluster at the plan of
// ops/bidi_lstm_kernel.py::chain_plan: C CTAs a cluster, R rows a cluster
// (16 or 32), U units a CTA and the product's ks k ranges. wh is
// Wh [2, H, 4H] in bf16, cell, gy and dz bf16 (8-byte aligned), the gates
// f32 (16-byte aligned; cudaErrorMisalignedAddress otherwise). A plan the
// kernel cannot take returns cudaErrorInvalidValue.
extern "C" int clstm_bidi_lstm_bwd_chain16(const int32_t* lengths,
                                           const float* gates,
                                           const bf16* cell, const bf16* gy,
                                           const bf16* wh, bf16* dz, int B,
                                           int T, int H, int C, int R, int U,
                                           int ks, void* stream) {
  return chain16(lengths, gates, cell, gy, wh, dz, B, T, H, C, R, U, ks,
                 stream);
}

// Bytes of dynamic shared memory a CTA of a chain16 plan takes (0: not a
// plan the kernel takes).
extern "C" long long clstm_bidi_lstm_bwd_chain16_smem(int H, int C, int R,
                                                      int U, int ks) {
  return plan16(H, C, R, U, ks);
}

// Clusters of a chain16 plan the current device holds at once, or minus a
// CUDA error.
extern "C" int clstm_bidi_lstm_bwd_chain16_clusters(int H, int C, int R,
                                                    int U, int ks) {
  return clusters16(H, C, R, U, ks);
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

// Bytes of scratch the bf16 reduction takes at plan (tt, spr)
// (ops/bidi_lstm_kernel.py::reduce_plan): x staged as [x | 1 | 0..] in
// bf16 [B·T, roundup(D+1, 64)], y staged per direction [B·T, 2,
// roundup(H, 64)], dz staged per direction [B·T, 2, roundup(4H, 8)] where
// H is odd, wx staged [2, D, roundup(4H, 64)] and,
// with more than one frame range, the dW partials [ranges, 2, D+1+H, 4H]
// f32; each 256-byte aligned.
extern "C" long long clstm_bidi_lstm_bwd_bf16_scratch(int B, int T, int D,
                                                       int H, int tt,
                                                       int spr) {
  return red16(B, T, D, H, tt, spr).bytes;
}

// The bf16 mode: x [B,T,D] (bf16 where x_bf16, else f32), y [B,T,2H] and
// dz [B,T,2,4H] bf16 (dz 16-byte aligned), wx [2,D,4H] f32 (rounded to
// bf16 here); dw [2, D+1+H, 4H] f32 and dx (unless NULL) [B,T,D] in x's type.
// The plan (reduce_plan): nw gate columns per dW tile and nwd columns d
// per dx tile (64, 128 or 200), slices of tt frames along T (a power of
// two up to 64), spr slices per frame range. scratch: the bytes of
// clstm_bidi_lstm_bwd_bf16_scratch at that plan, 256-byte aligned.
extern "C" int clstm_bidi_lstm_bwd_reduce_bf16(
    const void* x, int x_bf16, const bf16* y, const bf16* dz, const float* wx,
    void* scratch, float* dw, void* dx, int B, int T, int D, int H, int nw,
    int tt, int spr, int nwd, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (!valid_nw(nw) || !valid_nw(nwd) || tt < 1 || tt > SLICE ||
      (tt & (tt - 1)) || spr < 1)
    return (int)cudaErrorInvalidValue;
  if (!aligned16(dz) || ((uintptr_t)scratch & 255))
    return (int)cudaErrorMisalignedAddress;
  if (!encode_tiled()) return (int)cudaErrorNotSupported;
  const Red16 r = red16(B, T, D, H, tt, spr);
  const int G = r.G, M = r.M;
  unsigned char* sc = static_cast<unsigned char*>(scratch);
  bf16* xp = reinterpret_cast<bf16*>(sc);
  bf16* yp = reinterpret_cast<bf16*>(sc + r.off_y);
  bf16* wp = reinterpret_cast<bf16*>(sc + r.off_w);
  // One launch stages x, y, dz at odd H, and wx where dx is asked for.
  StageJobs js = {};
  add_job(js, x, !x_bf16, xp, r.N, D, r.Dp, D);
  add_job(js, y, false, yp, 2LL * r.N, H, r.Hp, -1);
  const bf16* zz = dz;
  int z1 = G;
  if (r.zstage) {
    bf16* zp = reinterpret_cast<bf16*>(sc + r.off_z);
    add_job(js, dz, false, zp, 2LL * r.N, G, r.Gq, -1);
    zz = zp, z1 = r.Gq;
  }
  if (dx != nullptr) add_job(js, wx, true, wp, 2LL * D, G, r.Gp, -1);
  bwd_stage_kernel<<<(unsigned)((js.total + 255) / 256), 256, 0, st>>>(js);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int yw = 2 * r.Hp, y1 = r.Hp;

  // dW: [B, T, columns] maps, boxes of 64 columns x tt frames x bb rows.
  CUtensorMap xm, ym, zm;
  const uint32_t box3[3] = {64, (uint32_t)tt, (uint32_t)r.bb};
  const uint64_t xd[3] = {(uint64_t)r.Dp, (uint64_t)T, (uint64_t)B};
  const uint64_t xs[2] = {2ull * r.Dp, 2ull * r.Dp * T};
  const uint64_t yd[3] = {(uint64_t)yw, (uint64_t)T, (uint64_t)B};
  const uint64_t yst[2] = {2ull * yw, 2ull * yw * T};
  const uint64_t zd[3] = {2ull * z1, (uint64_t)T, (uint64_t)B};
  const uint64_t zs[2] = {4ull * z1, 4ull * z1 * T};
  if (!bf16_map(&xm, xp, 3, xd, xs, box3) ||
      !bf16_map(&ym, yp, 3, yd, yst, box3) ||
      !bf16_map(&zm, zz, 3, zd, zs, box3))
    return (int)cudaErrorInvalidValue;
  const Dw16Args a = {
      r.ranges > 1 ? reinterpret_cast<float*>(sc + r.off_part) : dw,
      D, H, M, G, y1, z1, tt, r.bb, r.ntb, r.S, spr, r.nx, r.nm,
      (G + nw - 1) / nw};
  e = nw == 64    ? launch_dw16<64>(r, xm, ym, zm, a, st)
      : nw == 128 ? launch_dw16<128>(r, xm, ym, zm, a, st)
                  : launch_dw16<200>(r, xm, ym, zm, a, st);
  if (e != cudaSuccess) return (int)e;
  if (r.ranges > 1) {
    const int total = 2 * M * G;
    bwd_dw_sum_kernel<<<(total + 255) / 256, 256, 0, st>>>(
        reinterpret_cast<const float*>(sc + r.off_part), dw, r.ranges, total);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (dx == nullptr) return 0;

  // dx: dz as [B·T, 2·z1] (a direction's q past 4H read the other
  // direction's or the staged padding, against the staged wx's zero
  // columns), wx staged [2D, Gp].
  CUtensorMap zm2, wm;
  const uint32_t zbox[2] = {64, 64}, wbox[2] = {64, (uint32_t)nwd};
  const uint64_t zd2[2] = {2ull * z1, (uint64_t)r.N}, zs2[1] = {4ull * z1};
  const uint64_t wd[2] = {(uint64_t)r.Gp, 2ull * D}, ws[1] = {2ull * r.Gp};
  if (!bf16_map(&zm2, zz, 2, zd2, zs2, zbox) ||
      !bf16_map(&wm, wp, 2, wd, ws, wbox))
    return (int)cudaErrorInvalidValue;
  const Dx16Args b = {dx, r.N, D, z1, r.Gp / 64, (D + nwd - 1) / nwd,
                      x_bf16};
  e = nwd == 64    ? launch_dx16<64>(r, zm2, wm, b, st)
      : nwd == 128 ? launch_dx16<128>(r, zm2, wm, b, st)
                   : launch_dx16<200>(r, zm2, wm, b, st);
  return (int)e;
}
