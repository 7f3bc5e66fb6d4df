// K1: the fused factorized STLT scan, carry-native, for Hopper (sm_90a).
//
// Replaces: repro/kernels/stlt_scan.py::_kernel, the Pallas TPU kernel that
// repro/kernels/ops.py::_run_kernel launches.
//
// What it computes, per row (one (batch, head) pair) and per chunk c of C
// tokens, with X_c [C, d] and the complex carry h [S, d] at the chunk start:
//
//     z_c   = M X_c + A h_re + B h_im
//     h_re' = Pre X_c + dec_re h_re - dec_im h_im
//     h_im' = Pim X_c + dec_re h_im + dec_im h_re
//
// The carry starts at h0. In the one chunk where gate[row, c] fires it also
// writes the snapshot carry [Spre; Spim] X_c + sdec * h (chunk-START h);
// a row whose gate never fires (valid == 0) returns h0. Rows of X past N
// read as zeros and their z is not written, so the caller pads nothing.
//
// What bounds it: the operators (M [C,C], A, B [C,S], Pre, Pim [S,C]) are
// per row and reused by every chunk, so device-memory traffic is x in, z
// out and the operators once per block. The work is about 6 MFLOP per
// (row, chunk) at C = 128, S = 64, d = 64, in fp32 FMA (no TF32: the port
// holds the kernel to its plain version at fp32 rounding). So fp32
// arithmetic bounds it, and the chunk axis is a true recurrence.
//
// What the design does about it: one block owns one (row, 16-column
// d-slice) and walks the chunks in order, keeping the carry in shared
// memory. Hopper runs blocks in no order, so the TPU grid's sequential
// chunk axis becomes this loop; the recurrence is independent per feature
// column, so d/16 slices per row are free parallelism (32 rows x 4 slices
// = 128 blocks at batch 4). The block stages its row's operators in shared
// memory once (192 KB at C = 128, S = 64) and double-buffers the carry, so
// the chunk loop reads nothing but X from device memory. Each thread keeps
// an 8 x 2 output tile in registers: per 4-deep step it reads eight float4
// operator rows and four float2 of X from shared memory for 64 FMAs. The
// in-chunk Toeplitz M is lower-triangular, so a tile's k loop stops at its
// last row. The snapshot operators are read from device memory (L2), since
// they serve one chunk per row. One 128-thread block fits on an SM, so
// latency hiding is thin; wgmma / TMA staging is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kBD = 16;       // feature columns per block
constexpr int kTR = 8;        // output rows per thread tile
constexpr int kTC = 2;        // output columns per thread tile
constexpr int kThreads = 128;

__device__ __forceinline__ float lane(const float4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

// acc[r][*] += sum_{k < kend} op[(r0 + r) * ld + k] * xs[k][j0 .. j0+1],
// all in shared memory; op rows are float4-aligned (ld % 4 == 0), kend % 4 == 0.
__device__ __forceinline__ void tile_mac(float (&acc)[kTR][kTC],
                                         const float* op, int ld, int r0,
                                         const float* xs, int j0, int kend) {
  for (int k = 0; k < kend; k += 4) {
    float4 mv[kTR];
#pragma unroll
    for (int r = 0; r < kTR; ++r) {
      mv[r] = *reinterpret_cast<const float4*>(op + (r0 + r) * ld + k);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float2 xv = *reinterpret_cast<const float2*>(xs + (k + kk) * kBD + j0);
#pragma unroll
      for (int r = 0; r < kTR; ++r) {
        const float w = lane(mv[r], kk);
        acc[r][0] = fmaf(w, xv.x, acc[r][0]);
        acc[r][1] = fmaf(w, xv.y, acc[r][1]);
      }
    }
  }
}

__device__ __forceinline__ void copy4(float* dst, const float* src, int n) {
  const float4* s = reinterpret_cast<const float4*>(src);
  float4* d = reinterpret_cast<float4*>(dst);
  for (int i = threadIdx.x; i < n / 4; i += blockDim.x) d[i] = __ldg(s + i);
}

__global__ void __launch_bounds__(kThreads)
stlt_scan_kernel(const int* __restrict__ gate, const float* __restrict__ x,
                 const float* __restrict__ m, const float* __restrict__ a,
                 const float* __restrict__ b, const float* __restrict__ pre,
                 const float* __restrict__ pim, const float* __restrict__ dec,
                 const float* __restrict__ h0re, const float* __restrict__ h0im,
                 const float* __restrict__ spre, const float* __restrict__ spim,
                 const float* __restrict__ sdec, float* __restrict__ z,
                 float* __restrict__ hre_out, float* __restrict__ him_out,
                 int N, int d, int C, int S, int nc) {
  extern __shared__ __align__(16) float smem[];
  const int row = blockIdx.y;
  const int col0 = blockIdx.x * kBD;
  const int S2 = 2 * S;
  float* Ms = smem;              // [C][C]   M
  float* As = Ms + C * C;        // [C][S]   A
  float* Bs = As + C * S;        // [C][S]   B
  float* Ps = Bs + C * S;        // [2S][C]  Pre rows, then Pim rows
  float* xs = Ps + S2 * C;       // [C][kBD] X_c slice
  float* hcur = xs + C * kBD;    // [2S][kBD] carry: re rows, then im rows
  float* hnxt = hcur + S2 * kBD;

  copy4(Ms, m + (size_t)row * C * C, C * C);
  copy4(As, a + (size_t)row * C * S, C * S);
  copy4(Bs, b + (size_t)row * C * S, C * S);
  copy4(Ps, pre + (size_t)row * S * C, S * C);
  copy4(Ps + S * C, pim + (size_t)row * S * C, S * C);

  const float* decr = dec + (size_t)row * S2;   // dec[row][0][:]
  const float* deci = decr + S;                 // dec[row][1][:]
  const float* sdr = sdec + (size_t)row * S2;
  const float* sdi = sdr + S;
  const size_t hrow = (size_t)row * S * d;

  int any_gate = 0;
  for (int c = threadIdx.x; c < nc; c += blockDim.x)
    any_gate |= gate[(size_t)row * nc + c] > 0;
  const bool fires = __syncthreads_or(any_gate);

  for (int e = threadIdx.x; e < S * kBD; e += blockDim.x) {
    const int s = e / kBD, col = col0 + e % kBD;
    const bool in = col < d;
    const float r = in ? h0re[hrow + (size_t)s * d + col] : 0.f;
    const float i = in ? h0im[hrow + (size_t)s * d + col] : 0.f;
    hcur[e] = r;
    hcur[S * kBD + e] = i;
    if (!fires && in) {
      hre_out[hrow + (size_t)s * d + col] = r;
      him_out[hrow + (size_t)s * d + col] = i;
    }
  }

  const int cgroups = kBD / kTC;
  const int ztiles = (C / kTR) * cgroups;
  const int htiles = (S2 / kTR) * cgroups;
  for (int c = 0; c < nc; ++c) {
    for (int e = threadIdx.x; e < C * kBD; e += blockDim.x) {
      const int n = c * C + e / kBD, col = col0 + e % kBD;
      xs[e] = (n < N && col < d) ? x[((size_t)row * N + n) * d + col] : 0.f;
    }
    __syncthreads();

    // z_c = M X_c + A h_re + B h_im
    for (int t = threadIdx.x; t < ztiles; t += blockDim.x) {
      const int i0 = (t / cgroups) * kTR, j0 = (t % cgroups) * kTC;
      float acc[kTR][kTC] = {};
      tile_mac(acc, Ms, C, i0, xs, j0, i0 + kTR);
      tile_mac(acc, As, S, i0, hcur, j0, S);
      tile_mac(acc, Bs, S, i0, hcur + S * kBD, j0, S);
#pragma unroll
      for (int r = 0; r < kTR; ++r) {
        const int n = c * C + i0 + r;
        if (n >= N) break;
        float* zr = z + ((size_t)row * N + n) * d;
#pragma unroll
        for (int q = 0; q < kTC; ++q)
          if (col0 + j0 + q < d) zr[col0 + j0 + q] = acc[r][q];
      }
    }

    // the gated snapshot: [Spre; Spim] X_c + sdec * h(chunk start)
    if (gate[(size_t)row * nc + c] > 0) {
      for (int t = threadIdx.x; t < htiles; t += blockDim.x) {
        const int s0 = (t / cgroups) * kTR, j0 = (t % cgroups) * kTC;
        float acc[kTR][kTC] = {};
        // Spre and Spim are separate arrays and a tile may straddle them
        // when S % 8 != 0, so each row takes its own base pointer
#pragma unroll
        for (int r = 0; r < kTR; ++r) {
          const int sp = s0 + r;
          const float* op = sp < S ? spre + ((size_t)row * S + sp) * C
                                   : spim + ((size_t)row * S + sp - S) * C;
          for (int k = 0; k < C; k += 4) {
            const float4 w = __ldg(reinterpret_cast<const float4*>(op + k));
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              const float2 xv =
                  *reinterpret_cast<const float2*>(xs + (k + kk) * kBD + j0);
              const float wk = lane(w, kk);
              acc[r][0] = fmaf(wk, xv.x, acc[r][0]);
              acc[r][1] = fmaf(wk, xv.y, acc[r][1]);
            }
          }
        }
#pragma unroll
        for (int r = 0; r < kTR; ++r) {
          const int sp = s0 + r;
          const int s = sp < S ? sp : sp - S;
          const float dr = sdr[s], di = sdi[s];
#pragma unroll
          for (int q = 0; q < kTC; ++q) {
            const int col = col0 + j0 + q;
            if (col >= d) continue;
            const float hr = hcur[s * kBD + j0 + q];
            const float hi = hcur[(S + s) * kBD + j0 + q];
            if (sp < S)
              hre_out[hrow + (size_t)s * d + col] = acc[r][q] + dr * hr - di * hi;
            else
              him_out[hrow + (size_t)s * d + col] = acc[r][q] + dr * hi + di * hr;
          }
        }
      }
    }

    // carry update into the other buffer: [Pre; Pim] X_c + dec * h
    for (int t = threadIdx.x; t < htiles; t += blockDim.x) {
      const int s0 = (t / cgroups) * kTR, j0 = (t % cgroups) * kTC;
      float acc[kTR][kTC] = {};
      tile_mac(acc, Ps, C, s0, xs, j0, C);
#pragma unroll
      for (int r = 0; r < kTR; ++r) {
        const int sp = s0 + r;
        const int s = sp < S ? sp : sp - S;
        const float dr = decr[s], di = deci[s];
#pragma unroll
        for (int q = 0; q < kTC; ++q) {
          const float hr = hcur[s * kBD + j0 + q];
          const float hi = hcur[(S + s) * kBD + j0 + q];
          hnxt[sp * kBD + j0 + q] =
              sp < S ? acc[r][q] + dr * hr - di * hi : acc[r][q] + dr * hi + di * hr;
        }
      }
    }
    __syncthreads();
    float* tmp = hcur;
    hcur = hnxt;
    hnxt = tmp;
  }
}

}  // namespace

extern "C" {

// Shared memory the kernel needs for chunk C and S nodes, in bytes.
size_t stlt_scan_smem_bytes(int C, int S) {
  return sizeof(float) *
         ((size_t)C * C + 4 * (size_t)C * S + (size_t)C * kBD + 4 * (size_t)S * kBD);
}

// Launches K1 on `stream` and returns cudaGetLastError() (0 on success).
// All pointers are device pointers to contiguous fp32 (gate: int32) arrays:
// gate [BH, nc]; x [BH, N, d]; m [BH, C, C]; a, b [BH, C, S];
// pre, pim, spre, spim [BH, S, C]; dec, sdec [BH, 2, S]; h0re, h0im,
// hre_out, him_out [BH, S, d]; z [BH, N, d]. Needs C % 8 == 0, S % 4 == 0.
int stlt_scan_launch(const void* gate, const void* x, const void* m,
                     const void* a, const void* b, const void* pre,
                     const void* pim, const void* dec, const void* h0re,
                     const void* h0im, const void* spre, const void* spim,
                     const void* sdec, void* z, void* hre_out, void* him_out,
                     int BH, int N, int d, int C, int S, void* stream) {
  const int nc = (N + C - 1) / C;
  const size_t smem = stlt_scan_smem_bytes(C, S);
  cudaError_t err = cudaFuncSetAttribute(
      stlt_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((d + kBD - 1) / kBD, BH);
  stlt_scan_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const int*)gate, (const float*)x, (const float*)m, (const float*)a,
      (const float*)b, (const float*)pre, (const float*)pim, (const float*)dec,
      (const float*)h0re, (const float*)h0im, (const float*)spre,
      (const float*)spim, (const float*)sdec, (float*)z, (float*)hre_out,
      (float*)him_out, N, d, C, S, nc);
  return (int)cudaGetLastError();
}

}  // extern "C"
