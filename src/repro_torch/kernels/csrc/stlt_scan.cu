// K1: the fused factorized STLT scan, chunk-parallel on Hopper's tensor
// cores (sm_90a).
//
// Replaces: repro/kernels/stlt_scan.py::_kernel, the Pallas TPU kernel that
// repro/kernels/ops.py::_run_kernel launches.
//
// What it computes, per row (one (batch, head) pair) and per chunk c of C
// tokens, with X_c [C, d] and the complex carry h_c [S, d] at the chunk
// start (h_0 = h0):
//
//     z_c     = M X_c + A h_re,c + B h_im,c
//     h_c+1   = [Pre; Pim] X_c + dec * h_c        (complex, per node)
//
// In the one chunk where gate[row, c] fires it also writes the snapshot
// carry [Spre; Spim] X_c + sdec * h_c; a row whose gate never fires
// (valid == 0) returns h0 bit for bit. Rows of X past N read as zeros and
// their z is not written, so the caller pads nothing.
//
// What bounds it on an H100: per (row, chunk) at C = 128, S = 64, d = 64
// the products take ~5.3 MFLOP against 64 KB of x in and z out, ~80 flops a
// byte. In fp32 FMA (67 TFLOP/s) that is operation-bound: 0.65 ms at
// 8 rows x 131,072 tokens (43.3 GFLOP). As 3xTF32 on the tensor cores
// (3 x 43.3 GFLOP at 495 TFLOP/s) it is 0.26 ms, and the bytes (537 MB at
// 3.35 TB/s) 0.16 ms. The carry recurrence is sequential in c, but it is
// linear and elementwise per (node, column).
//
// What the design does about it: the chunk axis splits into three product
// launches, so parallelism grows with N instead of walking the chunks in one
// block, after one launch that packs the operators:
//
//   0. pack, one thread per fragment float4: the caller's row-major
//      operators into the mma A fragment order the products read (below).
//   1. carry_in, one block per (row, chunk < nc-1, column slice):
//      U_c = [Pre; Pim] X_c, written to the carry buffer H[row, c+1]; and
//      one more block per (row, slice) for the snapshot's product
//      [Spre; Spim] X_c* in the chunk c* where the gate fires, so that its
//      work (the same shape) does not lengthen one readout block.
//   2. carry_scan, one thread per (row, node, column): h_c+1 = dec*h_c + U_c
//      over the chunks in fp32 on the CUDA cores, in place, so H[row, c]
//      becomes the chunk-start carry (H[row, 0] = h0). Sixteen chunks'
//      loads are in flight per thread. Rows whose gate never fires get h0.
//   3. readout, one block per (row, chunk, column slice):
//      z_c = [M | A | B] [X_c; h_re,c; h_im,c] as one K = C + 2S product;
//      in chunk c* it adds the snapshot's carry term sdec * h_c*.
//
// The products run as 3xTF32 mma.sync.m16n8k8: each fp32 operand a is
// hi = tf32(a) (round to nearest, ties away: add and mask) plus lo = a - hi,
// which the tensor cores read truncated to TF32, and each k-step adds
// lo.hi, hi.lo and hi.hi into the fp32 accumulator (K2's split). The tensor
// cores truncate as they accumulate; K1's chain is 3 x (C + 2S)/8 = 96
// k-steps an output (tests/test_torch_k1_design.py emulates it). mma.sync
// rather than wgmma: a TF32 wgmma reads B from shared memory K-major only,
// and both B operands here (X_c, h) are row-major in k, so they would need a
// transpose per chunk. The operators (A operands) are per row, packed once
// per call by launch 0 in mma fragment order ([m-tile][k-step][lane][4]), so
// each warp reads a k-step's fragment from L2 as one coalesced float4 per
// lane, with the next 4-8 in flight (read from the caller's row-major layout
// instead, two float2 per lane a k-step touch 16 cache lines, not 4, and the
// readout ran slower on the card). X_c and h come into shared memory by
// cp.async, all of a block's copies in flight at once, at a row stride of
// the slice width + 8 floats, where the B fragments' reads hit 32 distinct
// banks. Eight warps take the 16-row m-tiles of the output; each keeps the
// slice's columns of fp32 accumulators. A slice is 64 columns, or 32 where
// 64 would give fewer blocks than SMs (batch 1 at N = 1000: 64 blocks for
// 132 SMs), and then three blocks fit on an SM. M is lower-triangular, so an
// m-tile's k loop over X_c stops at its diagonal, and the pack skips M's
// fragments above it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kScanThreads = 256;
constexpr int kScanUnroll = 16;  // carry-scan chunks whose loads are in flight together

// The product kernels' tile: BN feature columns per block (8 mma n-tiles at
// 64, 4 at 32), shared rows padded to BN + 8 floats so the B fragments'
// reads hit 32 distinct banks, and the k-steps of operator fragments kept in
// flight. 64 columns keep the most work per operator fetch; 32 double the
// blocks (and fit three on an SM) when the grid would not fill the card.
template <int BN>
struct Tile {
  static constexpr int kNT = BN / 8;
  static constexpr int kLd = BN + 8;
  static constexpr int kDepth = BN == 64 ? 8 : 4;
  static constexpr int kMinBlocks = BN == 64 ? 2 : 3;
};

// hi = a rounded to TF32 (nearest, ties away from zero), lo = a - hi (exact
// in fp32), which the tensor cores read truncated to TF32.
__device__ __forceinline__ void split(float a, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(a) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(a - __uint_as_float(hi));
}

// c += a b for one 16 x 8 x 8 TF32 tile. Fragments (gid = lane / 4,
// tig = lane % 4): a = rows gid, gid + 8 of k = tig, tig + 4; b0, b1 =
// k = tig, tig + 4 of column gid; c = rows gid, gid + 8 of columns 2 tig,
// 2 tig + 1.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc += W[the warp's m-tile, k-steps ks0 .. ks1) . B[k][0 .. BN) in
// 3xTF32. wf: the m-tile's A fragments, [k-step][lane] float4 in the order
// (row gid, k tig), (gid + 8, tig), (gid, tig + 4), (gid + 8, tig + 4);
// bs: shared [K][kLd], row k the B operand's k-th row. The next kDepth
// k-steps' fragments are in flight from L2 while one k-step's mma issue.
template <int BN>
__device__ __forceinline__ void mma_3xtf32(float (&acc)[Tile<BN>::kNT][4],
                                           const float4* __restrict__ wf, int ks0,
                                           int ks1, const float* bs, int lane) {
  using T = Tile<BN>;
  const int gid = lane >> 2, tig = lane & 3;
  float4 w[T::kDepth];
#pragma unroll
  for (int i = 0; i < T::kDepth; ++i)
    if (ks0 + i < ks1) w[i] = __ldg(wf + (ks0 + i) * 32 + lane);
  for (int k0 = ks0; k0 < ks1; k0 += T::kDepth) {
#pragma unroll
    for (int i = 0; i < T::kDepth; ++i) {
      const int ks = k0 + i;
      if (ks >= ks1) break;
      uint32_t ah[4], al[4];
      split(w[i].x, ah[0], al[0]);
      split(w[i].y, ah[1], al[1]);
      split(w[i].z, ah[2], al[2]);
      split(w[i].w, ah[3], al[3]);
      if (ks + T::kDepth < ks1) w[i] = __ldg(wf + (ks + T::kDepth) * 32 + lane);
      const float* b = bs + (ks * 8 + tig) * T::kLd + gid;
#pragma unroll
      for (int nt = 0; nt < T::kNT; ++nt) {
        uint32_t bh0, bl0, bh1, bl1;
        split(b[nt * 8], bh0, bl0);
        split(b[4 * T::kLd + nt * 8], bh1, bl1);
        mma_tf32(acc[nt], al, bh0, bh1);
        mma_tf32(acc[nt], ah, bl0, bl1);
        mma_tf32(acc[nt], ah, bh0, bh1);
      }
    }
  }
}

// Starts copying dst[r][0 .. BN) = src[r][col0 ..] for r < rows, from a
// row-major [*, d] array, zero where r >= live or the column is past d:
// with d % 4 == 0 as 16-byte cp.async, all in flight at once (tile_wait
// ends them), else by plain loads.
template <int BN>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src,
                                          int rows, int live, int d, int col0) {
  constexpr int kLd = Tile<BN>::kLd;
  if ((d & 3) == 0) {
    for (int e = threadIdx.x; e < rows * (BN / 4); e += blockDim.x) {
      const int r = e / (BN / 4), j = (e % (BN / 4)) * 4;
      const bool in = r < live && col0 + j < d;
      const float* g = in ? src + (size_t)r * d + col0 + j : src;
      const unsigned sa = (unsigned)__cvta_generic_to_shared(dst + r * kLd + j);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(sa),
                   "l"(g), "r"(in ? 16 : 0));
    }
  } else {
    for (int e = threadIdx.x; e < rows * BN; e += blockDim.x) {
      const int r = e / BN, j = e % BN;
      dst[r * kLd + j] =
          (r < live && col0 + j < d) ? __ldg(src + (size_t)r * d + col0 + j) : 0.f;
    }
  }
}

// Waits for this thread's load_tile copies; a __syncthreads must follow.
__device__ __forceinline__ void tile_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// out[r - first][col ..] = the accumulator's rows r0, r0 + 8 (those in
// [first, rows)), columns col + 8 nt and col + 8 nt + 1 (those < d); out is
// row-major [*, d].
template <int NT>
__device__ __forceinline__ void store_acc(float* out, const float (&acc)[NT][4],
                                          int r0, int rows, int d, int col,
                                          int first = 0) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (r < first || r >= rows) continue;
    float* o = out + (size_t)(r - first) * d;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int j = col + nt * 8;
      if ((d & 1) == 0) {
        if (j < d)
          *reinterpret_cast<float2*>(o + j) = make_float2(acc[nt][2 * h], acc[nt][2 * h + 1]);
      } else {
        if (j < d) o[j] = acc[nt][2 * h];
        if (j + 1 < d) o[j + 1] = acc[nt][2 * h + 1];
      }
    }
  }
}

// The scratch buffer of one call: the packed operators wz = [M | A | B]
// (ceil16(C)/16 m-tiles x (C + 2S)/8 k-steps of 32 float4 per row),
// wu = [Pre; Pim] and ws = [Spre; Spim] (ceil16(2S)/16 x C/8 x 32 float4
// each), then the carry buffer H [BH, nc, 2S, d].
struct Scratch {
  size_t nz, nu, hb;   // float4s of wz and of wu per row; floats of H
  Scratch(int BH, int N, int d, int C, int S) {
    nz = (size_t)((C + 15) / 16) * ((C + 2 * S) / 8) * 32;
    nu = (size_t)((2 * S + 15) / 16) * (C / 8) * 32;
    hb = (size_t)BH * ((N + C - 1) / C) * 2 * S * d;
  }
  size_t bytes(int BH) const { return 16 * (size_t)BH * (nz + 2 * nu) + 4 * hb; }
};

// 0. The operators from the caller's row-major arrays into mma A fragment
// order: per row, m-tile i, k-step j and lane 4 g + t, one float4 of W at
// (row, k) = (16 i + g, 8 j + t), (16 i + g + 8, 8 j + t), (16 i + g,
// 8 j + t + 4), (16 i + g + 8, 8 j + t + 4); rows past the operator's are
// zero. W is [M | A | B] (C rows, K = C + 2S) for wz, [Pre; Pim] for wu and
// [Spre; Spim] for ws (2S rows, K = C). M's fragments above its diagonal
// (k-step >= 2 i + 2), which the readout never reads, are not written.
__global__ void __launch_bounds__(256)
k1_pack(const float* __restrict__ m, const float* __restrict__ a,
        const float* __restrict__ b, const float* __restrict__ pre,
        const float* __restrict__ pim, const float* __restrict__ spre,
        const float* __restrict__ spim, float4* __restrict__ wz, float4* __restrict__ wu,
        float4* __restrict__ ws, int C, int S, size_t nz, size_t nu) {
  const size_t row = blockIdx.y;
  const int S2 = 2 * S, kx = C / 8;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < nz + 2 * nu;
       e += (size_t)gridDim.x * blockDim.x) {
    const int op = e < nz ? 0 : e < nz + nu ? 1 : 2;   // wz, wu, ws
    const int f = (int)(op == 0 ? e : e - nz - (op - 1) * nu);
    const int ks = op == 0 ? (C + S2) / 8 : kx;
    const int lane = f & 31, j = (f >> 5) % ks, i = (f >> 5) / ks;
    if (op == 0 && j < kx && j >= 2 * i + 2) continue;
    float v[4];
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int r = 16 * i + (lane >> 2) + 8 * (h & 1), k = 8 * j + (lane & 3) + 4 * (h >> 1);
      if (op == 0) {
        const size_t o = row * C + r;
        v[h] = r >= C ? 0.f
             : k < C ? __ldg(m + o * C + k)
             : k < C + S ? __ldg(a + o * S + k - C) : __ldg(b + o * S + k - C - S);
      } else {
        const float* p = op == 1 ? (r < S ? pre : pim) : (r < S ? spre : spim);
        v[h] = r >= S2 ? 0.f : __ldg(p + (row * S + (r < S ? r : r - S)) * C + k);
      }
    }
    float4* out = op == 0 ? wz + row * nz : (op == 1 ? wu : ws) + row * nu;
    out[f] = make_float4(v[0], v[1], v[2], v[3]);
  }
}

// 1. Blocks c < nc - 1: U_c = [Pre; Pim] X_c into H[row, c + 1]. Block
// nc - 1: the snapshot's product [Spre; Spim] X_c* into (hre_out, him_out)
// for the chunk c* where the row's gate fires (readout adds sdec * h_c*),
// so that no readout block carries a second product.
template <int BN>
__global__ void __launch_bounds__(kThreads, Tile<BN>::kMinBlocks)
k1_carry_in(const int* __restrict__ gate, const float* __restrict__ x,
            const float4* __restrict__ wu, const float4* __restrict__ ws,
            float* __restrict__ hb, float* __restrict__ hre_out,
            float* __restrict__ him_out, int N, int d, int C, int S, int nc) {
  extern __shared__ __align__(16) float smem[];   // [C][kLd]: X_c
  __shared__ int cstar;
  const int row = blockIdx.y, col0 = blockIdx.z * BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int S2 = 2 * S, ks = C / 8, mtiles = (S2 + 15) / 16;
  const bool snapshot = blockIdx.x == nc - 1;
  int c = blockIdx.x;
  if (snapshot) {
    if (threadIdx.x == 0) cstar = -1;
    __syncthreads();
    for (int i = threadIdx.x; i < nc; i += blockDim.x)
      if (gate[(size_t)row * nc + i] > 0) cstar = i;   // one-hot: one writer at most
    __syncthreads();
    if (cstar < 0) return;
    c = cstar;
  }
  load_tile<BN>(smem, x + ((size_t)row * N + (size_t)c * C) * d, C, min(C, N - c * C),
                d, col0);
  tile_wait();
  __syncthreads();
  const float4* w = (snapshot ? ws : wu) + (size_t)row * mtiles * ks * 32;
  for (int mt = warp; mt < mtiles; mt += kWarps) {
    float acc[Tile<BN>::kNT][4] = {};
    mma_3xtf32<BN>(acc, w + (size_t)mt * ks * 32, 0, ks, smem, lane);
    const int r0 = mt * 16 + (lane >> 2), col = col0 + 2 * (lane & 3);
    if (!snapshot) {
      store_acc(hb + ((size_t)row * nc + c + 1) * S2 * d, acc, r0, S2, d, col);
    } else {   // rows < S are h_re's, the rest h_im's; both [BH, S, d]
      store_acc(hre_out + (size_t)row * S * d, acc, r0, S, d, col);
      store_acc(him_out + (size_t)row * S * d, acc, r0, S2, d, col, S);
    }
  }
}

// 2. H[row, c] <- the chunk-start carry: h_0 = h0, h_c+1 = dec * h_c + U_c.
// One thread per (row, node, column); H[row, c] holds re rows then im rows.
__global__ void __launch_bounds__(kScanThreads)
k1_carry_scan(const int* __restrict__ gate, const float* __restrict__ dec,
              const float* __restrict__ h0re, const float* __restrict__ h0im,
              float* __restrict__ hb, float* __restrict__ hre_out,
              float* __restrict__ him_out, int BH, int d, int S, int nc) {
  const size_t sd = (size_t)S * d;
  const size_t e = (size_t)blockIdx.x * kScanThreads + threadIdx.x;
  if (e >= (size_t)BH * sd) return;
  const size_t row = e / sd, sj = e - row * sd;   // sj = s * d + column
  const int s = (int)(sj / d);
  const float dr = dec[row * 2 * S + s], di = dec[row * 2 * S + S + s];
  const float r0 = h0re[e], i0 = h0im[e];
  float* h = hb + row * nc * 2 * sd + sj;         // chunk c: re at c * 2sd, im sd after
  h[0] = r0;
  h[sd] = i0;
  const int* g = gate + row * nc;
  int fires = g[0] > 0;
  float hr = r0, hi = i0;
  for (int c0 = 1; c0 < nc; c0 += kScanUnroll) {
    float ur[kScanUnroll], ui[kScanUnroll];
#pragma unroll
    for (int k = 0; k < kScanUnroll; ++k) {
      if (c0 + k < nc) {
        ur[k] = h[(size_t)(c0 + k) * 2 * sd];
        ui[k] = h[(size_t)(c0 + k) * 2 * sd + sd];
        fires |= g[c0 + k] > 0;
      }
    }
#pragma unroll
    for (int k = 0; k < kScanUnroll; ++k) {
      if (c0 + k < nc) {
        const float nr = ur[k] + dr * hr - di * hi;
        hi = ui[k] + dr * hi + di * hr;
        hr = nr;
        h[(size_t)(c0 + k) * 2 * sd] = hr;
        h[(size_t)(c0 + k) * 2 * sd + sd] = hi;
      }
    }
  }
  if (!fires) {
    hre_out[e] = r0;
    him_out[e] = i0;
  }
}

// 3. z_c = [M | A | B] [X_c; h_re,c; h_im,c], and where gate[row, c] fires
// the snapshot's carry term: (hre_out, him_out) += sdec * h_c.
template <int BN>
__global__ void __launch_bounds__(kThreads, Tile<BN>::kMinBlocks)
k1_readout(const int* __restrict__ gate, const float* __restrict__ x,
           const float4* __restrict__ wz, const float* __restrict__ hb,
           const float* __restrict__ sdec, float* __restrict__ z,
           float* __restrict__ hre_out, float* __restrict__ him_out, int N, int d,
           int C, int S, int nc) {
  constexpr int kLd = Tile<BN>::kLd;
  extern __shared__ __align__(16) float smem[];   // [C + 2S][kLd]: X_c, h_re, h_im
  const int c = blockIdx.x, row = blockIdx.y, col0 = blockIdx.z * BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int S2 = 2 * S, live = min(C, N - c * C);
  float* hs = smem + C * kLd;
  load_tile<BN>(smem, x + ((size_t)row * N + (size_t)c * C) * d, C, live, d, col0);
  load_tile<BN>(hs, hb + ((size_t)row * nc + c) * S2 * d, S2, S2, d, col0);
  tile_wait();
  __syncthreads();
  const int kx = C / 8, kz = (C + S2) / 8, mtz = (C + 15) / 16;
  float* zc = z + ((size_t)row * N + (size_t)c * C) * d;
  for (int mt = warp; mt < mtz; mt += kWarps) {
    float acc[Tile<BN>::kNT][4] = {};
    const float4* wf = wz + ((size_t)row * mtz + mt) * kz * 32;
    mma_3xtf32<BN>(acc, wf, 0, min(kx, 2 * mt + 2), smem, lane);   // M: k <= row
    mma_3xtf32<BN>(acc, wf, kx, kz, smem, lane);
    store_acc(zc, acc, mt * 16 + gid, live, d, col0 + 2 * tig);
  }
  if (gate[(size_t)row * nc + c] <= 0) return;
  const float* sdr = sdec + (size_t)row * S2;
  for (int e = threadIdx.x; e < S * BN; e += blockDim.x) {
    const int s = e / BN, j = e % BN;
    if (col0 + j >= d) continue;
    const size_t o = ((size_t)row * S + s) * d + col0 + j;
    const float dr = sdr[s], di = sdr[S + s];
    const float hr = hs[s * kLd + j], hi = hs[(S + s) * kLd + j];
    hre_out[o] = hre_out[o] + dr * hr - di * hi;
    him_out[o] = him_out[o] + dr * hi + di * hr;
  }
}

// The pack, the two product launches and the scan between them, at tile
// width BN.
template <int BN>
cudaError_t launch(const void* const* in, void* scratch, void* z, void* hre_out,
                   void* him_out, int BH, int N, int d, int C, int S, cudaStream_t st) {
  constexpr int kLd = Tile<BN>::kLd;
  const int nc = (N + C - 1) / C;
  const int dblocks = (d + BN - 1) / BN;
  const size_t smem_in = sizeof(float) * (size_t)C * kLd;
  const size_t smem_out = sizeof(float) * (size_t)(C + 2 * S) * kLd;
  const Scratch sc(BH, N, d, C, S);
  float4* wz = (float4*)scratch;
  float4* wu = wz + (size_t)BH * sc.nz;
  float4* ws = wu + (size_t)BH * sc.nu;
  float* hb = (float*)(ws + (size_t)BH * sc.nu);
  const int* gate = (const int*)in[0];
  const float* x = (const float*)in[1];
  cudaError_t err = cudaFuncSetAttribute(
      k1_carry_in<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_in);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(k1_readout<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_out);
  if (err != cudaSuccess) return err;
  k1_pack<<<dim3((unsigned)((sc.nz + 2 * sc.nu + 255) / 256), BH), 256, 0, st>>>(
      (const float*)in[2], (const float*)in[3], (const float*)in[4], (const float*)in[5],
      (const float*)in[6], (const float*)in[7], (const float*)in[8], wz, wu, ws, C, S,
      sc.nz, sc.nu);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  k1_carry_in<BN><<<dim3(nc, BH, dblocks), kThreads, smem_in, st>>>(
      gate, x, wu, ws, hb, (float*)hre_out, (float*)him_out, N, d, C, S, nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long lanes = (long long)BH * S * d;
  k1_carry_scan<<<(unsigned)((lanes + kScanThreads - 1) / kScanThreads), kScanThreads,
                  0, st>>>(gate, (const float*)in[9], (const float*)in[10],
                           (const float*)in[11], hb, (float*)hre_out, (float*)him_out, BH,
                           d, S, nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  k1_readout<BN><<<dim3(nc, BH, dblocks), kThreads, smem_out, st>>>(
      gate, x, wz, hb, (const float*)in[12], (float*)z, (float*)hre_out,
      (float*)him_out, N, d, C, S, nc);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory of the largest launch (the readout at 64 columns) for chunk
// C and S nodes.
size_t stlt_scan_smem_bytes(int C, int S) {
  return sizeof(float) * (size_t)(C + 2 * S) * Tile<64>::kLd;
}

// Bytes of the scratch buffer stlt_scan_launch needs: the packed operators
// and the carry buffer.
size_t stlt_scan_scratch_bytes(int BH, int N, int d, int C, int S) {
  return Scratch(BH, N, d, C, S).bytes(BH);
}

// Launches K1's four kernels on `stream` and returns cudaGetLastError()
// (0 on success). All pointers are device pointers to contiguous fp32
// (gate: int32) arrays: gate [BH, nc]; x [BH, N, d]; m [BH, C, C]; a, b
// [BH, C, S]; pre, pim, spre, spim [BH, S, C]; dec, sdec [BH, 2, S]; h0re,
// h0im, hre_out, him_out [BH, S, d]; z [BH, N, d]; scratch, 16-byte
// aligned, of stlt_scan_scratch_bytes. Needs C % 8 == 0, S % 4 == 0,
// 1 <= BH <= 65535, and at most one chunk of a row whose gate fires
// (ops.py's gate is one-hot or all zero). Tiles of 64 columns, or of 32
// where 64 would give fewer blocks than the card has SMs.
int stlt_scan_launch(const void* gate, const void* x, const void* m, const void* a,
                     const void* b, const void* pre, const void* pim, const void* spre,
                     const void* spim, const void* dec, const void* h0re,
                     const void* h0im, const void* sdec, void* scratch, void* z,
                     void* hre_out, void* him_out, int BH, int N, int d, int C, int S,
                     void* stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const void* in[13] = {gate, x, m, a, b, pre, pim, spre, spim, dec, h0re, h0im, sdec};
  const long long blocks64 = (long long)BH * ((N + C - 1) / C) * ((d + 63) / 64);
  const cudaStream_t st = (cudaStream_t)stream;
  err = blocks64 < sms
            ? launch<32>(in, scratch, z, hre_out, him_out, BH, N, d, C, S, st)
            : launch<64>(in, scratch, z, hre_out, him_out, BH, N, d, C, S, st);
  return (int)err;
}

}  // extern "C"
