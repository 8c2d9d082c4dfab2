// The affine layer's products in the bf16 mode, on the bf16 tensor cores
// (sm_90a), with the contracts of clstm_tpu_torch/ops/affine_kernel.py's
// plain versions:
//
//   forward (clstm_affine_fwd): out [M, N] = x16 [M, K] · W16 [K, N] + bias,
//     bias f32 (the hoisted projection passes its bf16-rounded bias), out
//     f32 or rounded to bf16. This is the softmax's and the other affine
//     layers' x·W + b (models/spec.py::_AffineBF16) and the hoisted input
//     projection of both directions (ops/lstm.py::hoisted_projection).
//   backward (clstm_affine_bwd): from the f32 cotangent g [M, N],
//     dx [M, K] = bf16(g · W16ᵀ) (stored as bf16 or as its f32 value),
//     dW [K, N] = bf16(x16ᵀ · g) as f32, and db [N] = Σ_m g in f32.
//
// It replaces no Pallas kernel: the JAX package leaves these products to
// XLA (clstm_tpu/models/spec.py::_affine; the hoisted product of
// clstm_tpu/ops/pallas_lstm.py::_proj_stream). The port took them as f32
// products of the bf16-rounded operands, which run on the f32 pipes,
// because cuBLAS's bf16 kernels load lazily and make the host wait for the
// card at the first use of each, which a new batch shape can bring. These
// kernels load once: the instance a call takes depends on its output width
// alone, never on the row count M.
//
// Rounding points are those of the f32 route: bf16 operands, each product
// exact in f32, sums in f32; only the order of the sums differs. The
// cotangent g stays exact: each value is split into three bf16 parts,
// g = hi + mid + lo (hi and mid by truncation, lo the rest, exact wherever
// g's last bit is at least 2^-133, that is for every |g| >= 2^-110), and
// each backward product is three bf16 passes into one f32 sum: the bf16
// counterpart of the 3xTF32 split of the K2 reduction's f32 dx.
//
// What bounds them (an H100: 989 TFLOP/s bf16, 3.35 TB/s): at bidi2's
// widths and ~480k frame-rows, the hoisted product's 6.1e11 flop (0.62 ms)
// beside its 1.9 GB of x and xz (0.56 ms); the softmax forward's bytes (x
// in bf16, z in f32: 0.34 ms); the backward's 9.2e11 flop of its six
// passes (0.93 ms) and its reads of g. What the design does about it:
//   - one kernel template for the three products (affine_gemm_kernel<NW,
//     P>): two consumer warpgroups, each 64 output rows by NW columns on
//     wgmma m64nNWk16 (bf16, f32 accumulators), fed by TMA through a ring
//     of 64-deep stages in shared memory (128-byte swizzle, mbarriers);
//     thread 0 issues the copies;
//   - the forward accumulates in the tensor cores over the whole of K
//     (K <= a few hundred: the tensor cores' truncation as they accumulate
//     stays within ~K·2^-23 of the sum of |terms|; a bf16 GEMM with f32
//     accumulation does the same), with one stage's wgmmas in flight while
//     the next stage's are issued; at NW <= 128 two blocks share an SM, so
//     one's epilogue runs beside the other's products. dx sums 3·N terms
//     and dW 3·M: there each stage (the three parts of a 64-deep step)
//     accumulates from zero in the tensor cores and is added to the f32
//     sum with an ordinary add, as in the K2 reduction (accumulated whole
//     in the tensor cores, dx at N = 1,600 flipped 4 times the bf16
//     roundings of the f32 route);
//   - the tile width NW (64, 128 or 200) follows the output width that
//     the wrapper observes (1,600 for the hoist, 400 and 96 for the
//     softmaxes, 21 for the filter's; dW's K); the ragged edges of M and N
//     come in as TMA's zero fill and are masked in the epilogue;
//   - each block walks its tiles in turn, and its ring runs on across
//     them, so the next tile's copies are in flight during a tile's
//     epilogue;
//   - forward: x (K-major) and W (N-major) as they lie, no staging; the
//     bias and the rounding in the epilogue, so no f32 product and no cast
//     pass goes through device memory (a block an SM keeping its columns of
//     W16 resident, loaded once, and x16 alone in the ring was slower at
//     the hoisted product: 3.96 against 2.73 ms at two blocks an SM; a
//     ninth, producer warp was 3% faster there, but 288 threads held dx and
//     dW at NW = 200 to 168 registers, and their spills took bidi2's
//     backward from 2.8 to 4.7 ms);
//   - backward: one pass (affine_split_kernel) reads g once and writes its
//     parts as gs [M, 3, roundup(N, 8)] bf16, the padding columns zero,
//     with each block's column sums of g (db's partials); dx takes gs
//     (K-major; a step's three parts against one copy of W16's rows,
//     read K-major); dW is taken as dWᵀ = gsᵀ·x16, gs and x16 both
//     frame-major (the transpose bits read them as they lie): a block's
//     128 rows of N by NW columns of K, a frame slice of x16 once for the
//     three parts, over ranges of frames that fill the card, each range to
//     its own partial buffer; affine_sum_kernel adds the partials in a
//     fixed order and rounds dW: deterministic, no float atomics.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int ATOM = 64 * 128;  // a 64 x 64 bf16 tile: 128-byte rows
constexpr int THREADS = 256;    // two consumer warpgroups
constexpr int STAGES_MAX = 8;

// The three products. A's tiles are 64 x 64 atoms: FWD and DX take them
// K-major (rows of x16 or gs), DW M-major (frames of gs, its N as the
// wgmma's M: DW computes dWᵀ = gsᵀ·x16, so a block's NW columns run along
// K). B is NB atoms N-major (W16's rows in FWD, x16's frames in DW) or, in
// DX, one box of NW rows of W16 (K-major: W16's N is dx's K).
enum Product { FWD = 0, DX = 1, DW = 2 };

// A stage: FWD one 64-deep step of K; DX one 64-deep step of N, each
// warpgroup's rows of the three parts and the step's rows of W16; DW one
// 64-frame slice of each warpgroup's columns of the three parts and of
// x16's NW columns. FWD
// accumulates in the tensor cores over the whole of K (NW/2 accumulators a
// thread), so at NW <= 128 two blocks share an SM and one's epilogue runs
// beside the other's products. DX and DW sum 3·N and 3·M terms, over
// which the tensor cores' truncation would add up: each stage's partial
// sum (NW/2 more registers) is added to the f32 sum, one block an SM.
template <int NW, int P>
struct Ring {
  static constexpr int NB = (NW + 63) / 64;
  static constexpr int ABYTES = (P == FWD ? 2 : 6) * ATOM;
  static constexpr int BBYTES =
      P == DX ? (NW * 128 + 1023) / 1024 * 1024 : NB * ATOM;
  static constexpr int STAGE = ABYTES + BBYTES;
  static constexpr int BLOCKS = P == FWD && NW <= 128 ? 2 : 1;
  static constexpr int RING = (BLOCKS == 2 ? 96 : 200) * 1024;
  static constexpr int STAGES =
      RING / STAGE < STAGES_MAX ? RING / STAGE : STAGES_MAX;
  static constexpr int SMEM = STAGES * STAGE + 1024;  // + alignment slack
};

struct GemmArgs {
  void* out;          // FWD [M, N], DX [M, K], DW partials [ranges, K, N]
                      // (DW's tiles are of dWᵀ: rows along N, columns K)
  const float* bias;  // FWD: [N], added to the sum
  int out_bf16;       // FWD, DX: the output rounded to bf16, stored as bf16
  int rows, cols;     // the output's rows and columns (a range's, in DW)
  int ntn;            // column tiles of NW
  int tpr;            // tiles per range: row tiles of 128 x ntn
  int kst;            // 64-deep steps: FWD over K, DX over N (per part),
                      // DW over the M frames (slices)
  int spr;            // DW: slices per range
  int tiles;          // tpr x ranges
};

template <int P>
__device__ __forceinline__ int stages_of(const GemmArgs& a, int t) {
  if (P != DW) return a.kst;
  const int r = t / a.tpr;
  return min(a.kst, (r + 1) * a.spr) - r * a.spr;
}

// Block b takes tiles b, b + gridDim.x, ...; a tile is (range, row tile,
// column tile), the column tile fastest, so the blocks that run together
// share their A tiles in L2. Its stages run through the ring in one
// sequence over all its tiles: thread 0 keeps the copies STAGES ahead,
// refilling a stage's slot once every warp has released it (the empty
// barrier's 8 arrivals). FWD keeps one stage's wgmmas in flight and
// releases a stage once the next one's are issued; DX and DW wait for each
// stage's partial sum.
template <int NW, int P>
__global__ void __launch_bounds__(THREADS, (Ring<NW, P>::BLOCKS))
    affine_gemm_kernel(const __grid_constant__ CUtensorMap amap,
                       const __grid_constant__ CUtensorMap bmap,
                       const GemmArgs a) {
  using R = Ring<NW, P>;
  extern __shared__ unsigned char smraw[];
  constexpr int nst = R::STAGES;
  __shared__ __align__(8) uint64_t full[nst], empty[nst];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      ((uintptr_t)smraw + 1023) & ~(uintptr_t)1023);
  const int tid = threadIdx.x, wg = tid >> 7;

  if (tid == 0) {
    for (int s = 0; s < nst; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], THREADS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The block's stages over all its tiles, counted by every thread, so
  // that warp 0's refill condition is uniform.
  int total = 0;
  for (int t = blockIdx.x; t < a.tiles; t += gridDim.x)
    total += stages_of<P>(a, t);

  // Thread 0's cursor: the tile and stage of the next copy.
  int pt = blockIdx.x, ps = 0;
  auto issue = [&](int slot) {
    const int range = pt / a.tpr, rem = pt - range * a.tpr;
    const int row0 = rem / a.ntn * 128, col0 = rem % a.ntn * NW;
    const int na = row0 + 64 < a.rows ? 2 : 1;
    int nb = 0;
    for (int c = 0; c < R::NB; ++c) nb += col0 + 64 * c < a.cols;
    unsigned char* st = ring + slot * R::STAGE;
    if constexpr (P == FWD) {
      mbar_expect_tx(&full[slot], (na + nb) * ATOM);
      for (int w = 0; w < na; ++w)
        tma_2d(st + w * ATOM, &amap, &full[slot], 64 * ps, row0 + 64 * w);
      for (int c = 0; c < nb; ++c)
        tma_2d(st + (2 + c) * ATOM, &bmap, &full[slot], col0 + 64 * c,
               64 * ps);
    } else if constexpr (P == DX) {
      mbar_expect_tx(&full[slot], 3 * na * ATOM + NW * 128);
      for (int w = 0; w < na; ++w)
        for (int part = 0; part < 3; ++part)
          tma_3d(st + (3 * w + part) * ATOM, &amap, &full[slot], 64 * ps,
                 part, row0 + 64 * w);
      tma_2d(st + 6 * ATOM, &bmap, &full[slot], 64 * ps, col0);
    } else {
      const int f0 = 64 * (range * a.spr + ps);
      mbar_expect_tx(&full[slot], (3 * na + nb) * ATOM);
      for (int w = 0; w < na; ++w)
        for (int part = 0; part < 3; ++part)
          tma_3d(st + (3 * w + part) * ATOM, &amap, &full[slot],
                 row0 + 64 * w, part, f0);
      for (int c = 0; c < nb; ++c)
        tma_2d(st + (6 + c) * ATOM, &bmap, &full[slot], col0 + 64 * c, f0);
    }
    if (++ps == stages_of<P>(a, pt)) {
      ps = 0;
      pt += gridDim.x;
    }
  };
  if (tid == 0)
    for (int k = 0; k < total && k < nst; ++k) issue(k);

  // Warp 0 refills the slot of stage k as a whole (its lanes wait
  // together; lane 0 issues), so no lane of a warpgroup diverges around
  // the wgmma.
  auto refill = [&](int k) {
    if (tid < 32 && k + nst < total) {
      mbar_wait(&empty[k % nst], (k / nst) & 1);
      if (tid == 0) issue(k % nst);
      __syncwarp();
    }
  };

  const int w4 = (tid >> 5) & 3, l = tid & 31;
  float acc[NW / 2];
  float tmp[P == FWD ? 1 : NW / 2];
#pragma unroll
  for (int i = 0; i < (P == FWD ? 1 : NW / 2); ++i) tmp[i] = 0.0f;
  int k = 0;
  for (int t = blockIdx.x; t < a.tiles; t += gridDim.x) {
    const int range = t / a.tpr, rem = t - range * a.tpr;
    const int row0 = rem / a.ntn * 128, col0 = rem % a.ntn * NW;
    const bool active = row0 + 64 * wg < a.rows;
    const int ns = stages_of<P>(a, t);
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) acc[i] = 0.0f;
    for (int s = 0; s < ns; ++s, ++k) {
      const int slot = k % nst;
      mbar_wait(&full[slot], (k / nst) & 1);
      __syncwarp();
      if (active) {
        unsigned char* st = ring + slot * R::STAGE;
        const uint32_t sa = smem_addr(st + (P == FWD ? 1 : 3) * wg * ATOM);
        const uint32_t sb = smem_addr(st + R::ABYTES);
        // k16 step kk: 32 bytes on inside a K-major atom's 128-byte rows,
        // 16 rows (2048 bytes) on in an N-major one; SBO steps between
        // 8-row groups, LBO between an N-major operand's 64-column atoms.
        if constexpr (P == DX) {
          pin_all(tmp);
          wgmma_fence();
#pragma unroll
          for (int part = 0; part < 3; ++part)
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              Wgmma<NW, 0, 0>::run(
                  tmp, sw128_desc(sa + part * ATOM + 32 * kk, 16, 1024),
                  sw128_desc(sb + 32 * kk, 16, 1024), part | kk);
          wgmma_commit();
          wgmma_wait<0>();
          pin_all(tmp);
#pragma unroll
          for (int i = 0; i < NW / 2; ++i) acc[i] += tmp[i];
        } else if constexpr (P == DW) {
          pin_all(tmp);
          wgmma_fence();
#pragma unroll
          for (int part = 0; part < 3; ++part)
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              Wgmma<NW, 1, 1>::run(
                  tmp, sw128_desc(sa + part * ATOM + 2048 * kk, ATOM, 1024),
                  sw128_desc(sb + 2048 * kk, ATOM, 1024), part | kk);
          wgmma_commit();
          wgmma_wait<0>();
          pin_all(tmp);
#pragma unroll
          for (int i = 0; i < NW / 2; ++i) acc[i] += tmp[i];
        } else {
          pin_all(acc);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            Wgmma<NW, 0, 1>::run(acc, sw128_desc(sa + 32 * kk, 16, 1024),
                                 sw128_desc(sb + 2048 * kk, ATOM, 1024),
                                 s | kk);
          wgmma_commit();
          wgmma_wait<1>();  // the stage before's products are done
          pin_all(acc);
        }
      }
      __syncwarp();
      // Release a stage once no wgmma reads it: DX's and DW's at once,
      // FWD's one stage later (the tile's last after the loop).
      const int done = P == FWD ? k - 1 : k;
      if (P != FWD || s > 0) {
        if (l == 0) mbar_arrive(&empty[done % nst]);
        refill(done);
      }
    }
    if constexpr (P == FWD) {
      if (active) {
        wgmma_wait<0>();
        pin_all(acc);
      }
      __syncwarp();
      if (l == 0) mbar_arrive(&empty[(k - 1) % nst]);
      refill(k - 1);
    }
    if (!active) continue;

    // Accumulator layout (warp w4 of the warpgroup, lane l): acc[4c + 2h +
    // e] is row 16 w4 + l/4 + 8h, column 8c + 2(l%4) + e of the tile.
    const bool pairs = (a.cols & 1) == 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + 64 * wg + 16 * w4 + (l >> 2) + 8 * h;
      if (r >= a.rows) continue;
      const size_t base = (size_t)r * a.cols;
#pragma unroll
      for (int c = 0; c < NW / 8; ++c) {
        const int col = col0 + 8 * c + 2 * (l & 3);
        if (col >= a.cols) continue;
        const bool one = col + 1 < a.cols;
        float v0 = acc[4 * c + 2 * h], v1 = acc[4 * c + 2 * h + 1];
        if constexpr (P == DW) {  // dWᵀ's (r, col) is partial dW[col][r]
          float* o = static_cast<float*>(a.out) +
                     ((size_t)range * a.cols + col) * a.rows + r;
          o[0] = v0;
          if (one) o[a.rows] = v1;
          continue;
        }
        if constexpr (P == FWD) {
          v0 += a.bias[col];
          if (one) v1 += a.bias[col + 1];
        }
        if constexpr (P == DX) {
          v0 = __bfloat162float(__float2bfloat16_rn(v0));
          v1 = __bfloat162float(__float2bfloat16_rn(v1));
        }
        if (a.out_bf16) {
          bf16* o = static_cast<bf16*>(a.out) + base + col;
          if (pairs)
            *reinterpret_cast<__nv_bfloat162*>(o) =
                __floats2bfloat162_rn(v0, v1);
          else {
            o[0] = __float2bfloat16_rn(v0);
            if (one) o[1] = __float2bfloat16_rn(v1);
          }
        } else {
          float* o = static_cast<float*>(a.out) + base + col;
          if (pairs)
            *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
          else {
            o[0] = v0;
            if (one) o[1] = v1;
          }
        }
      }
    }
  }
}

// v = hi + mid + lo exactly (see the top of the file), each as bf16 bits:
// hi and mid by truncation (so none overflows), lo rounded to nearest;
// the residues keep v's sign, so a negative zero splits into three.
__device__ __forceinline__ void split3(float v, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  const uint32_t u = __float_as_uint(v);
  const float r1 = copysignf(v - __uint_as_float(u & 0xffff0000u), v);
  const uint32_t u1 = __float_as_uint(r1);
  const float r2 = copysignf(r1 - __uint_as_float(u1 & 0xffff0000u), v);
  hi = u >> 16;
  mid = u1 >> 16;
  lo = (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(r2));
}

// g [M, N] f32 -> gs [M, 3, N8] bf16 (hi, mid, lo; columns N..N8 zero) and
// dbpart [gridDim.x, N], block x's column sums of g over its rows
// [x·rpb, (x+1)·rpb). A block is 8 warps over 128 columns (4 a lane) and
// its rows, warp w taking every eighth row; the warps' sums are added in a
// fixed order.
__global__ void __launch_bounds__(256)
    affine_split_kernel(const float* __restrict__ g, bf16* __restrict__ gs,
                        float* __restrict__ dbpart, int M, int N, int N8,
                        int rpb) {
  __shared__ float red[8][128];
  const int lane = threadIdx.x & 31, rl = threadIdx.x >> 5;
  const int c0 = blockIdx.y * 128 + 4 * lane;
  const int r0 = blockIdx.x * rpb, r1 = min(M, r0 + rpb);
  const bool vec = (N & 3) == 0;
  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (c0 < N8) {
#pragma unroll 4
    for (int r = r0 + rl; r < r1; r += 8) {
      const float* gr = g + (size_t)r * N;
      float v[4];
      if (vec && c0 < N) {
        const float4 q = *reinterpret_cast<const float4*>(gr + c0);
        v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) v[i] = c0 + i < N ? gr[c0 + i] : 0.0f;
      }
      uint32_t hi[4], mid[4], lo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        split3(v[i], hi[i], mid[i], lo[i]);
        s[i] += v[i];
      }
      bf16* o = gs + (size_t)r * 3 * N8 + c0;
      *reinterpret_cast<uint2*>(o) =
          make_uint2(hi[0] | hi[1] << 16, hi[2] | hi[3] << 16);
      *reinterpret_cast<uint2*>(o + N8) =
          make_uint2(mid[0] | mid[1] << 16, mid[2] | mid[3] << 16);
      *reinterpret_cast<uint2*>(o + 2 * N8) =
          make_uint2(lo[0] | lo[1] << 16, lo[2] | lo[3] << 16);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) red[rl][4 * lane + i] = s[i];
  __syncthreads();
  if (rl != 0) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = c0 + i;
    if (c >= N) continue;
    float t = 0.0f;
#pragma unroll
    for (int q = 0; q < 8; ++q) t += red[q][4 * lane + i];
    dbpart[(size_t)blockIdx.x * N + c] = t;
  }
}

// dw [K·N] = bf16(Σ_r dwpart[r]) as f32, for i < KN; db [N] = Σ_p
// dbpart[p], for KN <= i < KN + N; each sum in a fixed order.
__global__ void affine_sum_kernel(const float* __restrict__ dwpart,
                                  float* __restrict__ dw, int R, int KN,
                                  const float* __restrict__ dbpart,
                                  float* __restrict__ db, int P, int N) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  float s = 0.0f;
  if (i < KN) {
    for (int r = 0; r < R; ++r) s += dwpart[(size_t)r * KN + i];
    dw[i] = __bfloat162float(__float2bfloat16_rn(s));
  } else if (i - KN < N) {
    const int n = i - KN;
    for (int p = 0; p < P; ++p) s += dbpart[(size_t)p * N + n];
    db[n] = s;
  }
}

// ---------------------------------------------------------------------------
// Host side: tensor maps and launches
// ---------------------------------------------------------------------------

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// A [outer, inner] bf16 matrix with rows ld elements apart, in boxes of
// box_inner x box_outer.
bool map2d(CUtensorMap* m, const void* base, int inner, int outer, int ld,
           int box_inner, int box_outer) {
  const uint64_t dims[2] = {(uint64_t)inner, (uint64_t)outer};
  const uint64_t strides[1] = {2ull * ld};
  const uint32_t box[2] = {(uint32_t)box_inner, (uint32_t)box_outer};
  return bf16_map(m, base, 2, dims, strides, box);
}

// gs [M, 3, N8] as dims {N, 3, M}: a box is 64 columns of one part by 64
// rows, and columns past N arrive as zeros.
bool map_parts(CUtensorMap* m, const void* gs, int N, int N8, int M) {
  const uint64_t dims[3] = {(uint64_t)N, 3, (uint64_t)M};
  const uint64_t strides[2] = {2ull * N8, 6ull * N8};
  const uint32_t box[3] = {64, 1, 64};
  return bf16_map(m, gs, 3, dims, strides, box);
}

// One product on the blocks the card holds at once (one or two an SM, each
// holding ~100 or ~200 KB of shared memory).
template <int NW, int P>
cudaError_t launch(const CUtensorMap& am, const CUtensorMap& bm,
                   const GemmArgs& a, cudaStream_t st) {
  auto kern = affine_gemm_kernel<NW, P>;
  constexpr int smem = Ring<NW, P>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, per = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kern, THREADS,
                                                    smem);
  if (e != cudaSuccess) return e;
  if (per < 1) return cudaErrorInvalidConfiguration;
  const int grid = a.tiles < per * sms ? a.tiles : per * sms;
  kern<<<grid, THREADS, smem, st>>>(am, bm, a);
  return cudaGetLastError();
}

template <int P>
cudaError_t launch_nw(int nw, const CUtensorMap& am, const CUtensorMap& bm,
                      const GemmArgs& a, cudaStream_t st) {
  return nw == 64    ? launch<64, P>(am, bm, a, st)
         : nw == 128 ? launch<128, P>(am, bm, a, st)
                     : launch<200, P>(am, bm, a, st);
}

cudaError_t split(const float* g, void* gs, float* dbpart, int P, int M,
                  int N, cudaStream_t st) {
  const int N8 = cdiv(N, 8) * 8;
  affine_split_kernel<<<dim3(P, cdiv(N8, 128)), 256, 0, st>>>(
      g, static_cast<bf16*>(gs), dbpart, M, N, N8, cdiv(M, P));
  return cudaGetLastError();
}

}  // namespace

// Each entry launches on `stream` and returns a cudaError_t (0 on
// success). Pointers are device pointers, the bf16 matrices' 16-byte
// aligned with rows a multiple of 8 elements apart (ldx >= K, ldw >= N);
// M, K, N >= 1. nw, nwx, nww: the tile widths of
// ops/affine_kernel.py::tile_n (64, 128 or 200), nww for dW's K.

// out [M, N] (bf16 where out_bf16, else f32) = x [M, K] · w [K, N] + bias
// [N] (f32), x and w bf16.
extern "C" int clstm_affine_fwd(const void* x, int ldx, const void* w,
                                int ldw, const float* bias, void* out,
                                int out_bf16, int M, int K, int N, int nw,
                                void* stream) {
  if (!valid_nw(nw) || M < 1 || K < 1 || N < 1 || ldx < K || ldw < N ||
      (ldx & 7) || (ldw & 7))
    return (int)cudaErrorInvalidValue;
  if (!aligned16(x) || !aligned16(w)) return (int)cudaErrorMisalignedAddress;
  if (!encode_tiled()) return (int)cudaErrorNotSupported;
  CUtensorMap am, bm;
  if (!map2d(&am, x, K, M, ldx, 64, 64) || !map2d(&bm, w, N, K, ldw, 64, 64))
    return (int)cudaErrorInvalidValue;
  GemmArgs a = {};
  a.out = out, a.bias = bias, a.out_bf16 = out_bf16;
  a.rows = M, a.cols = N;
  a.ntn = cdiv(N, nw), a.tpr = cdiv(M, 128) * a.ntn;
  a.kst = cdiv(K, 64), a.spr = 0, a.tiles = a.tpr;
  return (int)launch_nw<FWD>(nw, am, bm, a, (cudaStream_t)stream);
}

// The split alone: gs [M, 3, roundup(N, 8)] bf16 and dbpart [P, N] f32
// from g [M, N] f32 (16-byte aligned, as gs).
extern "C" int clstm_affine_split(const float* g, void* gs, float* dbpart,
                                  int P, int M, int N, void* stream) {
  if (M < 1 || N < 1 || P < 1) return (int)cudaErrorInvalidValue;
  if (!aligned16(g) || !aligned16(gs)) return (int)cudaErrorMisalignedAddress;
  return (int)split(g, gs, dbpart, P, M, N, (cudaStream_t)stream);
}

// From g [M, N] f32, x [M, K] and w [K, N] bf16: dx [M, K] (unless NULL;
// bf16 where dx_bf16, else the rounded values as f32), dw [K, N] f32
// (unless NULL) and db [N] f32 (unless NULL). Scratch: gs [M, 3,
// roundup(N, 8)] bf16, dbpart [P, N] f32, dwpart [R, K, N] f32 where dw is
// asked for, R = ceil(ceil(M / 64) / spr) ranges of spr 64-frame slices.
extern "C" int clstm_affine_bwd(const float* g, const void* x, int ldx,
                                const void* w, int ldw, void* gs,
                                float* dbpart, int P, float* dwpart, int R,
                                int spr, void* dx, int dx_bf16, float* dw,
                                float* db, int M, int K, int N, int nwx,
                                int nww, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (M < 1 || K < 1 || N < 1 || P < 1 || ldx < K || ldw < N || (ldx & 7) ||
      (ldw & 7) || (dx && !valid_nw(nwx)) ||
      (dw && (!valid_nw(nww) || spr < 1 || cdiv(cdiv(M, 64), spr) != R)))
    return (int)cudaErrorInvalidValue;
  if (!aligned16(g) || !aligned16(gs) || !aligned16(x) || !aligned16(w))
    return (int)cudaErrorMisalignedAddress;
  if (!encode_tiled()) return (int)cudaErrorNotSupported;
  cudaError_t e = split(g, gs, dbpart, P, M, N, st);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap pm;
  if (!map_parts(&pm, gs, N, cdiv(N, 8) * 8, M))
    return (int)cudaErrorInvalidValue;
  if (dx) {
    CUtensorMap wm;
    if (!map2d(&wm, w, N, K, ldw, 64, nwx)) return (int)cudaErrorInvalidValue;
    GemmArgs a = {};
    a.out = dx, a.out_bf16 = dx_bf16;
    a.rows = M, a.cols = K;
    a.ntn = cdiv(K, nwx), a.tpr = cdiv(M, 128) * a.ntn;
    a.kst = cdiv(N, 64), a.spr = 0, a.tiles = a.tpr;
    if ((e = launch_nw<DX>(nwx, pm, wm, a, st)) != cudaSuccess) return (int)e;
  }
  if (dw) {
    CUtensorMap xm;
    if (!map2d(&xm, x, K, M, ldx, 64, 64)) return (int)cudaErrorInvalidValue;
    GemmArgs a = {};
    a.out = dwpart;
    a.rows = N, a.cols = K;
    a.ntn = cdiv(K, nww), a.tpr = cdiv(N, 128) * a.ntn;
    a.kst = cdiv(M, 64), a.spr = spr, a.tiles = a.tpr * R;
    if ((e = launch_nw<DW>(nww, pm, xm, a, st)) != cudaSuccess) return (int)e;
  }
  if (dw || db) {
    const int KN = dw ? K * N : 0, Nb = db ? N : 0;
    affine_sum_kernel<<<cdiv(KN + Nb, 256), 256, 0, st>>>(
        dwpart, dw, R, KN, dbpart, db, P, Nb);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  return 0;
}
