// Bidirectional LSTM backward (K2), f32, for sm_90a.
//
// Replaces the TPU kernel clstm_tpu/ops/pallas_lstm.py::_bwd_kernel
// (proj_in=False; reached through bidi_lstm_pallas's custom VJP, _vjp_bwd).
// The TPU kernel runs the backward chain and then, in its own body, the
// contractions dW += [x|1]ᵀ·dz, dWh += h_prevᵀ·dz and dx = dz·Wxᵀ. Here
// that is three kernels, with the same contracts as
// clstm_tpu_torch/ops/lstm.py::bidi_lstm_bwd_chain_plain and
// bidi_lstm_bwd_reduce_plain:
//
//   chain (clstm_bidi_lstm_bwd_chain): K1's gates [B,T,2,4H] and cell
//     [B,T,2,H], the cotangent gy [B,T,2H] and WhT [2,4H,H] (Wh transposed)
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
//     (rows: dWx, the bias row, dWh; h_prev read from y at the frame
//     before in chain order), and, when dx is asked for,
//     dx [B,T,D] = Σ_dir dz·Wxᵀ.
//
// What bounds them. The chain is a serial recurrence of T steps per row
// tile: per step a [ROWS,4H] x [4H,H] product (Dh) after the elementwise
// gate algebra, with two block barriers. Like K3, latency of per-thread
// serial work bounds it, not bytes or flops. The reduction is ~6e10 flop
// (dW) + ~2e10 flop (dx) at B=256, T=1024, D=48, H=100: a parallel f32
// product, bound by the FMA rate of the non-tensor pipes.
//
// Design (simple first):
//   chain: grid = (ceil(B/ROWS) row tiles, 2 directions); dz of the step,
//     the Dc carry and the four per-gate partial sums of Dh live in shared
//     memory. Phase A: a thread per (row, unit) forms dh, dc, dz and Dc.
//     Phase B: a thread per (gate, unit k) sums dz[gate block]·WhT[gate
//     block, k] for the tile's rows, reading WhT coalesced across k from
//     L2; phase A of the next step adds the four partials into Dh.
//   reduction: a 64x64 output tile per block, 16-frame (or 16-column)
//     slices staged in shared memory, 4x4 outputs per thread. The dW sum
//     over B·T is split into a fixed number of frame ranges, each written
//     to its own partial buffer, and a second pass adds the partials in a
//     fixed order: deterministic, no float atomics. dx sums over the 2·4H
//     dz columns of a frame inside one block: deterministic as well.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 4;
constexpr int TILE = 64;  // output tile edge of the reduction kernels
constexpr int KS = 16;    // reduction slice staged per step
constexpr int LD = TILE + 4;  // padded row of a staged slice (fewer bank
                              // conflicts on transposed stores)
constexpr int RED_THREADS = 256;

__global__ void bwd_chain_kernel(const int32_t* __restrict__ lengths,
                                 const float* __restrict__ gates,
                                 const float* __restrict__ cell,
                                 const float* __restrict__ gy,
                                 const float* __restrict__ whT,
                                 float* __restrict__ dz, int B, int T,
                                 int H) {
  extern __shared__ float smem[];
  __shared__ int lens[ROWS];
  const int G = 4 * H;
  float* zs = smem;                 // [ROWS, 4H]  dz of the current step
  float* part = zs + ROWS * G;      // [4, ROWS, H] partial Dh per gate
  float* dcs = part + 4 * ROWS * H; // [ROWS, H]   Dc carry

  const int dir = blockIdx.y;
  const int b0 = blockIdx.x * ROWS;
  whT += (size_t)dir * G * H;

  if (threadIdx.x < ROWS) {
    const int b = b0 + threadIdx.x;
    int L = 0;
    if (b < B) L = lengths ? lengths[b] : T;
    lens[threadIdx.x] = min(max(L, 0), T);
  }
  for (int i = threadIdx.x; i < ROWS * G; i += blockDim.x) {
    zs[i] = 0.0f;
    part[i] = 0.0f;
  }
  for (int i = threadIdx.x; i < ROWS * H; i += blockDim.x) dcs[i] = 0.0f;
  __syncthreads();
  int lmax = 0;
  for (int r = 0; r < ROWS; ++r) lmax = max(lmax, lens[r]);

  // Padded frames: dz exactly 0.
  for (int r = 0; r < ROWS && b0 + r < B; ++r) {
    const int L = lens[r];
    for (int i = threadIdx.x; i < (T - L) * G; i += blockDim.x) {
      const int t = L + i / G;
      const int j = i - (t - L) * G;
      dz[(((size_t)(b0 + r) * T + t) * 2 + dir) * G + j] = 0.0f;
    }
  }

  for (int s = lmax - 1; s >= 0; --s) {
    // Phase A: dh, dc, dz and the Dc carry for every active (row, unit).
    for (int i = threadIdx.x; i < ROWS * H; i += blockDim.x) {
      const int r = i / H;
      const int k = i - r * H;
      const int L = lens[r];
      if (s < L) {
        const int b = b0 + r;
        const int t = dir == 0 ? s : L - 1 - s;
        const size_t f = ((size_t)b * T + t) * 2 + dir;
        const float* g = gates + f * G;
        const float gi = g[k], gf = g[H + k], go = g[2 * H + k],
                    ci = g[3 * H + k];
        const float c = cell[f * H + k];
        float cp = 0.0f;
        if (s > 0) {
          const int tp = dir == 0 ? t - 1 : t + 1;
          cp = cell[(((size_t)b * T + tp) * 2 + dir) * H + k];
        }
        float Dh = 0.0f;
        if (s < L - 1)
          Dh = part[(0 * ROWS + r) * H + k] + part[(1 * ROWS + r) * H + k] +
               part[(2 * ROWS + r) * H + k] + part[(3 * ROWS + r) * H + k];
        const float dh = gy[((size_t)b * T + t) * 2 * H + dir * H + k] + Dh;
        const float tc = tanhf(c);
        const float dc = dcs[i] + dh * go * (1.0f - tc * tc);
        const float d0 = dc * ci * gi * (1.0f - gi);
        const float d1 = dc * cp * gf * (1.0f - gf);
        const float d2 = dh * tc * go * (1.0f - go);
        const float d3 = dc * gi * (1.0f - ci * ci);
        float* z = zs + r * G;
        z[k] = d0;
        z[H + k] = d1;
        z[2 * H + k] = d2;
        z[3 * H + k] = d3;
        float* out = dz + f * G;
        out[k] = d0;
        out[H + k] = d1;
        out[2 * H + k] = d2;
        out[3 * H + k] = d3;
        dcs[i] = dc * gf;
      }
    }
    __syncthreads();
    // Phase B: partial Dh[r, k] over one gate block of dz.
    for (int i = threadIdx.x; i < G; i += blockDim.x) {
      const int gb = i / H;
      const int k = i - gb * H;
      float acc[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[r] = 0.0f;
      const float* w = whT + (size_t)gb * H * H + k;
      const float* z = zs + gb * H;
      for (int j = 0; j < H; ++j) {
        const float wj = w[(size_t)j * H];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) acc[r] = fmaf(z[r * G + j], wj, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) part[(gb * ROWS + r) * H + k] = acc[r];
    }
    __syncthreads();
  }
}

// One 64x64 tile of C += Aᵀ·Bm over a KS-deep slice staged in shared memory:
// As[kk][m], Bs[kk][n]; thread (ty, tx) owns rows ty*4.., columns tx*4.. .
__device__ __forceinline__ void tile_fma(const float (*As)[LD],
                                         const float (*Bs)[LD],
                                         float acc[4][4], int ty, int tx) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    float a[4], b[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      a[q] = As[kk][ty * 4 + q];
      b[q] = Bs[kk][tx * 4 + q];
    }
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[p][q] = fmaf(a[p], b[q], acc[p][q]);
  }
}

// dW partials: block (j tile, i tile, dir * nsplit + split) sums its frame
// range [split*chunk, (split+1)*chunk) of [x | 1 | h_prev]ᵀ·dz into
// part[split][dir][i][j], i < M = D+1+H, j < 4H.
__global__ void bwd_dw_partial_kernel(const float* __restrict__ x,
                                      const float* __restrict__ y,
                                      const float* __restrict__ dz,
                                      float* __restrict__ part, int B, int T,
                                      int D, int H, int nsplit, int chunk) {
  __shared__ float As[KS][LD];
  __shared__ float Bs[KS][LD];
  const int G = 4 * H, M = D + 1 + H;
  const int dir = blockIdx.z / nsplit;
  const int sp = blockIdx.z - dir * nsplit;
  const int i0 = blockIdx.y * TILE, j0 = blockIdx.x * TILE;
  const long long N = (long long)B * T;
  const long long n_begin = (long long)sp * chunk;
  const long long n_end = min(N, n_begin + chunk);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4] = {};
  for (long long n0 = n_begin; n0 < n_end; n0 += KS) {
    for (int e = threadIdx.x; e < KS * TILE; e += RED_THREADS) {
      const int kk = e / TILE, c = e - kk * TILE;
      const long long n = n0 + kk;
      const int i = i0 + c, j = j0 + c;
      float a = 0.0f, bv = 0.0f;
      if (n < n_end) {
        if (i < D) {
          a = x[n * D + i];
        } else if (i == D) {
          a = 1.0f;
        } else if (i < M) {
          const int k = i - D - 1;
          const int t = (int)(n % T);
          if (dir == 0) {
            if (t > 0) a = y[(n - 1) * 2 * H + k];
          } else {
            if (t + 1 < T) a = y[(n + 1) * 2 * H + H + k];
          }
        }
        if (j < G) bv = dz[(n * 2 + dir) * G + j];
      }
      As[kk][c] = a;
      Bs[kk][c] = bv;
    }
    __syncthreads();
    tile_fma(As, Bs, acc, ty, tx);
    __syncthreads();
  }
  float* out = part + ((size_t)sp * 2 + dir) * M * G;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int i = i0 + ty * 4 + p;
    if (i >= M) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = j0 + tx * 4 + q;
      if (j < G) out[(size_t)i * G + j] = acc[p][q];
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

// dx [N, D] = dz [N, 2·4H] · Wcat [2·4H, D], Wcat[dir·4H + j][d] =
// wx[dir][d][j]. Block (frame tile, d tile).
__global__ void bwd_dx_kernel(const float* __restrict__ dz,
                              const float* __restrict__ wx,
                              float* __restrict__ dx, long long N, int D,
                              int H) {
  __shared__ float As[KS][LD];
  __shared__ float Bs[KS][LD];
  const int G = 4 * H, K = 2 * G;
  const long long n0 = (long long)blockIdx.x * TILE;
  const int d0 = blockIdx.y * TILE;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4] = {};
  for (int q0 = 0; q0 < K; q0 += KS) {
    for (int e = threadIdx.x; e < KS * TILE; e += RED_THREADS) {
      // A: kk fastest, so a warp reads consecutive dz columns of a frame.
      const int m = e / KS, kk = e - m * KS;
      const long long n = n0 + m;
      const int q = q0 + kk;
      As[kk][m] = (n < N && q < K) ? dz[n * K + q] : 0.0f;
      const int kb = e / TILE, c = e - kb * TILE;
      const int qb = q0 + kb, d = d0 + c;
      float w = 0.0f;
      if (qb < K && d < D) {
        const int dir = qb / G, j = qb - dir * G;
        w = wx[((size_t)dir * D + d) * G + j];
      }
      Bs[kb][c] = w;
    }
    __syncthreads();
    tile_fma(As, Bs, acc, ty, tx);
    __syncthreads();
  }
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const long long n = n0 + ty * 4 + p;
    if (n >= N) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int d = d0 + tx * 4 + q;
      if (d < D) dx[n * D + d] = acc[p][q];
    }
  }
}

}  // namespace

// Each entry launches on `stream` and returns cudaGetLastError() (0 on
// success). All pointers are device pointers; `lengths` may be NULL (all
// T). B, T, D, H >= 1.

// dz [B,T,2,4H] from gates [B,T,2,4H], cell [B,T,2,H], gy [B,T,2H] and
// whT [2,4H,H].
extern "C" int clstm_bidi_lstm_bwd_chain(const int32_t* lengths,
                                         const float* gates,
                                         const float* cell, const float* gy,
                                         const float* whT, float* dz, int B,
                                         int T, int H, void* stream) {
  const size_t smem = (size_t)ROWS * 9 * H * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        bwd_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int threads = ((4 * H + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  const dim3 grid((B + ROWS - 1) / ROWS, 2);
  bwd_chain_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      lengths, gates, cell, gy, whT, dz, B, T, H);
  return (int)cudaGetLastError();
}

// Number of frame ranges the dW sum is split into, and the partial buffer
// the caller allocates: nsplit * 2 * (D+1+H) * 4H floats.
extern "C" int clstm_bidi_lstm_bwd_nsplit(int B, int T) {
  const long long N = (long long)B * T;
  long long n = (N + 4095) / 4096;
  return (int)(n < 1 ? 1 : (n > 64 ? 64 : n));
}

// dw [2, D+1+H, 4H] (and dx [B,T,D] unless dx is NULL) from x [B,T,D],
// y [B,T,2H], dz [B,T,2,4H], wx [2,D,4H]; part is scratch of
// clstm_bidi_lstm_bwd_nsplit(B, T) * 2 * (D+1+H) * 4H floats.
extern "C" int clstm_bidi_lstm_bwd_reduce(const float* x, const float* y,
                                          const float* dz, const float* wx,
                                          float* part, float* dw, float* dx,
                                          int B, int T, int D, int H,
                                          void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int G = 4 * H, M = D + 1 + H;
  const long long N = (long long)B * T;
  const int nsplit = clstm_bidi_lstm_bwd_nsplit(B, T);
  const int chunk = (int)((N + nsplit - 1) / nsplit);
  const dim3 grid((G + TILE - 1) / TILE, (M + TILE - 1) / TILE, 2 * nsplit);
  bwd_dw_partial_kernel<<<grid, RED_THREADS, 0, st>>>(x, y, dz, part, B, T, D,
                                                      H, nsplit, chunk);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int total = 2 * M * G;
  bwd_dw_sum_kernel<<<(total + 255) / 256, 256, 0, st>>>(part, dw, nsplit,
                                                         total);
  e = cudaGetLastError();
  if (e != cudaSuccess || dx == nullptr) return (int)e;
  const dim3 gx((unsigned)((N + TILE - 1) / TILE), (D + TILE - 1) / TILE);
  bwd_dx_kernel<<<gx, RED_THREADS, 0, st>>>(dz, wx, dx, N, D, H);
  return (int)cudaGetLastError();
}
