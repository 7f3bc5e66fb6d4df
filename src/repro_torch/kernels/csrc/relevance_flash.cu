// K2: the flash relevance readout for Hopper (sm_90a).
//
// Replaces: repro/kernels/relevance_flash.py::_flash_body (l.207), the
// Pallas TPU kernel that relevance_flash_kernel launches.
//
// What it computes, per row bh (one (batch, head) pair) of x, v [N, dh]:
//
//     L[t]    = lambda_k L[t-1] + x[t]            (per node k, complex)
//     R[n, m] = Re(sum_k mk_k L[n,k,:] . conj(L[m,k,:])) / sqrt(S)
//     z       = softmax_m(R + causal mask + key mask) v
//
// Bidirectional mode (kCausal = false) uses L = L_fwd + L_rev - x, with
// L_rev[t] = lambda L_rev[t+1] + x[t]. x arrives with masked keys zeroed;
// masked keys (km == 0) and rows past N score -1e30 with probability
// exactly 0, so a fully masked row returns 0, not NaN.
//
// What bounds it: the score contraction, 2 * (2 * S * dh) flops for every
// (query, key) pair: at BH = 32, N = 1000, S = 64, dh = 64, causal, that is
// about 262 GFLOP a call against a few MB of inputs, so fp32 arithmetic
// (67 TFLOP/s without tensor cores) bounds it, not memory. fp32 FMA only,
// no TF32: the kernel is held to its plain version at fp32 rounding, and
// the scores reach the hundreds, where TF32's 10-bit mantissa would move the
// softmax.
//
// What the design does about it. The TPU kernel rebuilds a tile's L with a
// Toeplitz operator [T*S, T] and keeps the query's [T, S*dh] coefficients
// in VMEM: 4 MiB and 2 MiB at T = 128, S = 64, far beyond a Hopper block's
// 227 KB. Here one 256-thread block owns (row, 128-query block) and walks
// the key blocks (only those at or below the diagonal when causal), and
// inside that the nodes. For each node it rebuilds that node's L rows of
// the query and the key block in shared memory with the one-step
// recurrence, seeded from the tile-start carry the host computed at this
// kernel's 128-row stride (reverse: the tile-end carry): O(T * dh) work per
// node instead of the Toeplitz product's O(T^2 * dh). The recurrence is
// split into 4 segments of 32 rows, so all 256 threads work: a first pass
// sums each segment from zero, the segment-start carries follow by lambda^32
// steps, and a second pass writes the rows. The node powers come from
// (log_mag, theta) on chip. Each thread then accumulates an 8 x 8 tile of
// Re(Lq . conj Lk) in registers from float4 shared-memory loads (16 loads
// per 256 FMAs), with rows ty + 16r and columns tx + 16c so the loads are
// conflict-free and a row's 16 columns-owners sit in one half-warp for the
// softmax reductions. After the node loop comes the online-softmax update
// and P.v through shared memory. Query nodes whose mask is 0 are skipped
// (their terms are 0). Blocks are launched longest-first (the last causal
// query blocks first). Not yet done (later work): overlapping one node's
// recurrence with the previous node's contraction, tensor-core (wgmma)
// contraction with split fp32, more than one block per SM.

#include <cuda_runtime.h>

namespace {

constexpr int kBlk = 128;            // query and key rows per block
constexpr int kSeg = 32;             // rows per recurrence segment
constexpr int kNSeg = kBlk / kSeg;
constexpr int kDh = 64;              // feature columns held (dh <= kDh)
constexpr int kLd = kDh + 4;         // row stride of the L buffers
constexpr int kPLd = kBlk + 4;       // row stride of the probability tile
constexpr int kThreads = 256;
constexpr float kNeg = -1e30f;

static_assert(kThreads == kNSeg * kDh, "one recurrence chain per thread");
static_assert(kBlk * kPLd <= 2 * kBlk * kLd, "P fits in the query L buffers");

// complex z = a * z + x
__device__ __forceinline__ void cstep(float& zr, float& zi, float ar, float ai,
                                      float xr, float xi) {
  const float r = fmaf(ar, zr, fmaf(-ai, zi, xr));
  zi = fmaf(ar, zi, fmaf(ai, zr, xi));
  zr = r;
}

__device__ __forceinline__ void stage_rows(float* dst, const float* src, int n0,
                                           int N, int dh) {
  for (int e = threadIdx.x; e < kBlk * kDh; e += kThreads) {
    const int row = e / kDh, col = e % kDh, n = n0 + row;
    dst[e] = (n < N && col < dh) ? src[(size_t)n * dh + col] : 0.f;
  }
}

// Rebuild node s's L rows for the query block (scaled by mks) and the key
// block into shared memory. Thread (seg, col) owns one column of one
// 32-row segment on both sides. Ends with the buffers complete (synced).
template <bool kCausal>
__device__ __forceinline__ void node_rows(
    const float* xq, const float* xk, float* Lqr, float* Lqi, float* Lkr,
    float* Lki, float* E, const float* hcre, const float* hcim,
    const float* gcre, const float* gcim, size_t cq, size_t ck, float lmag,
    float ang, float mks, int dh) {
  const int col = threadIdx.x % kDh, seg = threadIdx.x / kDh;
  const int r0 = seg * kSeg;
  float sn, cs;
  sincosf(ang, &sn, &cs);
  const float mag = expf(lmag);
  const float lr = mag * cs, li = mag * sn;
  sincosf(kSeg * ang, &sn, &cs);
  const float mag32 = expf(kSeg * lmag);
  const float pr = mag32 * cs, pi = mag32 * sn;     // lambda^32
  // E[(side * 2 + dir) * kNSeg + seg][col], re then im halves
  constexpr int kE = 2 * 2 * kNSeg * kDh;
  auto eidx = [&](int side, int dir, int sg) {
    return ((side * 2 + dir) * kNSeg + sg) * kDh + col;
  };
  const bool act = col < dh;
  const float* xqc = xq + r0 * kDh + col;
  const float* xkc = xk + r0 * kDh + col;

  if (act) {  // pass 1: each segment's sum from zero
    float qr = 0.f, qi = 0.f, kr = 0.f, ki = 0.f;
#pragma unroll 8
    for (int i = 0; i < kSeg; ++i) {
      cstep(qr, qi, lr, li, xqc[i * kDh], 0.f);
      cstep(kr, ki, lr, li, xkc[i * kDh], 0.f);
    }
    E[eidx(0, 0, seg)] = qr; E[kE + eidx(0, 0, seg)] = qi;
    E[eidx(1, 0, seg)] = kr; E[kE + eidx(1, 0, seg)] = ki;
    if (!kCausal) {
      qr = qi = kr = ki = 0.f;
#pragma unroll 8
      for (int i = kSeg - 1; i >= 0; --i) {
        cstep(qr, qi, lr, li, xqc[i * kDh], 0.f);
        cstep(kr, ki, lr, li, xkc[i * kDh], 0.f);
      }
      E[eidx(0, 1, seg)] = qr; E[kE + eidx(0, 1, seg)] = qi;
      E[eidx(1, 1, seg)] = kr; E[kE + eidx(1, 1, seg)] = ki;
    }
  }
  __syncthreads();

  if (!act) {  // columns past dh must read as zero in the contraction
    for (int i = 0; i < kSeg; ++i) {
      const int o = (r0 + i) * kLd + col;
      Lqr[o] = Lqi[o] = Lkr[o] = Lki[o] = 0.f;
    }
  } else {
    // pass 2 forward: the segment-start carry, then the rows
    float qr = hcre[cq + col], qi = hcim[cq + col];
    float kr = hcre[ck + col], ki = hcim[ck + col];
    for (int j = 0; j < seg; ++j) {
      cstep(qr, qi, pr, pi, E[eidx(0, 0, j)], E[kE + eidx(0, 0, j)]);
      cstep(kr, ki, pr, pi, E[eidx(1, 0, j)], E[kE + eidx(1, 0, j)]);
    }
    const float fq = kCausal ? mks : 1.f;
#pragma unroll 8
    for (int i = 0; i < kSeg; ++i) {
      const int o = (r0 + i) * kLd + col;
      cstep(qr, qi, lr, li, xqc[i * kDh], 0.f);
      cstep(kr, ki, lr, li, xkc[i * kDh], 0.f);
      Lqr[o] = qr * fq; Lqi[o] = qi * fq;
      Lkr[o] = kr; Lki[o] = ki;
    }
    if (!kCausal) {  // pass 2 reverse: L += L_rev - x, then the query mask
      qr = gcre[cq + col]; qi = gcim[cq + col];
      kr = gcre[ck + col]; ki = gcim[ck + col];
      for (int j = kNSeg - 1; j > seg; --j) {
        cstep(qr, qi, pr, pi, E[eidx(0, 1, j)], E[kE + eidx(0, 1, j)]);
        cstep(kr, ki, pr, pi, E[eidx(1, 1, j)], E[kE + eidx(1, 1, j)]);
      }
#pragma unroll 8
      for (int i = kSeg - 1; i >= 0; --i) {
        const int o = (r0 + i) * kLd + col;
        const float xqv = xqc[i * kDh], xkv = xkc[i * kDh];
        cstep(qr, qi, lr, li, xqv, 0.f);
        cstep(kr, ki, lr, li, xkv, 0.f);
        Lqr[o] = (Lqr[o] + qr - xqv) * mks;
        Lqi[o] = (Lqi[o] + qi) * mks;
        Lkr[o] = Lkr[o] + kr - xkv;
        Lki[o] = Lki[o] + ki;
      }
    }
  }
  __syncthreads();
}

template <bool kCausal>
__global__ void __launch_bounds__(kThreads, 1)
relevance_flash_kernel(const float* __restrict__ x, const float* __restrict__ v,
                       const float* __restrict__ lm, const float* __restrict__ th,
                       const float* __restrict__ mk, const float* __restrict__ km,
                       const float* __restrict__ hcre, const float* __restrict__ hcim,
                       const float* __restrict__ gcre, const float* __restrict__ gcim,
                       float* __restrict__ z, int N, int S, int dh, int nt) {
  extern __shared__ __align__(16) float smem[];
  float* xq = smem;                       // [kBlk][kDh] query-block x
  float* xk = xq + kBlk * kDh;            // [kBlk][kDh] key-block x
  float* Lqr = xk + kBlk * kDh;           // [kBlk][kLd] each
  float* Lqi = Lqr + kBlk * kLd;
  float* Lkr = Lqi + kBlk * kLd;
  float* Lki = Lkr + kBlk * kLd;
  float* E = Lki + kBlk * kLd;            // segment sums
  float* P = Lqr;                         // [kBlk][kPLd] after the node loop
  float* Vs = Lkr;                        // [kBlk][kDh] after the node loop

  const int bh = blockIdx.x;
  const int qb = nt - 1 - blockIdx.y;     // longest causal rows first
  const int lane = threadIdx.x & 31;
  const int tx = lane & 15;
  const int ty = (threadIdx.x >> 5) * 2 + (lane >> 4);
  const int dhp = (dh + 3) & ~3;
  const float scale = 1.0f / sqrtf((float)S);
  const float* xr = x + (size_t)bh * N * dh;
  const float* vr = v + (size_t)bh * N * dh;
  const float* kmr = km + (size_t)bh * N;
  const int q0 = qb * kBlk;

  float m[8], l[8], o[8][4];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    m[r] = kNeg;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) o[r][c] = 0.f;
  }

  stage_rows(xq, xr, q0, N, dh);
  const int kend = kCausal ? qb + 1 : nt;
  for (int kb = 0; kb < kend; ++kb) {
    const int k0 = kb * kBlk;
    stage_rows(xk, xr, k0, N, dh);
    __syncthreads();

    float acc[8][8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;

    for (int s = 0; s < S; ++s) {
      const float mks = mk[(size_t)bh * S + s];
      if (mks == 0.f) continue;   // the node adds 0 to every score
      const size_t cq = (((size_t)bh * nt + qb) * S + s) * dh;
      const size_t ck = (((size_t)bh * nt + kb) * S + s) * dh;
      node_rows<kCausal>(xq, xk, Lqr, Lqi, Lkr, Lki, E, hcre, hcim, gcre, gcim,
                         cq, ck, lm[(size_t)bh * S + s], th[(size_t)bh * S + s],
                         mks, dh);
      for (int d = 0; d < dhp; d += 4) {
#pragma unroll
        for (int part = 0; part < 2; ++part) {
          const float* Aq = part ? Lqi : Lqr;
          const float* Ak = part ? Lki : Lkr;
          float4 a[8];
#pragma unroll
          for (int r = 0; r < 8; ++r)
            a[r] = *reinterpret_cast<const float4*>(Aq + (ty + 16 * r) * kLd + d);
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            const float4 b = *reinterpret_cast<const float4*>(Ak + (tx + 16 * c) * kLd + d);
#pragma unroll
            for (int r = 0; r < 8; ++r) {
              float t = acc[r][c];
              t = fmaf(a[r].x, b.x, t);
              t = fmaf(a[r].y, b.y, t);
              t = fmaf(a[r].z, b.z, t);
              t = fmaf(a[r].w, b.w, t);
              acc[r][c] = t;
            }
          }
        }
      }
      __syncthreads();   // the next node overwrites the L buffers
    }

    // online softmax over this key block
    float kv[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int kc = k0 + tx + 16 * c;
      kv[c] = kc < N ? kmr[kc] : 0.f;
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int qrow = q0 + ty + 16 * r;
      float mx = kNeg;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const bool ok = kv[c] > 0.f && (!kCausal || k0 + tx + 16 * c <= qrow);
        acc[r][c] = ok ? acc[r][c] * scale : kNeg;
        mx = fmaxf(mx, acc[r][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mnew = fmaxf(m[r], mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const bool ok = kv[c] > 0.f && (!kCausal || k0 + tx + 16 * c <= qrow);
        const float p = ok ? expf(acc[r][c] - mnew) : 0.f;
        acc[r][c] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = expf(m[r] - mnew);
      l[r] = alpha * l[r] + sum;
      m[r] = mnew;
#pragma unroll
      for (int c = 0; c < 4; ++c) o[r][c] *= alpha;
    }

    // P.v through shared memory (the L buffers are free after the node loop)
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) P[(ty + 16 * r) * kPLd + tx + 16 * c] = acc[r][c];
    stage_rows(Vs, vr, k0, N, dh);
    __syncthreads();
    for (int k = 0; k < kBlk; ++k) {
      float vk[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) vk[c] = Vs[k * kDh + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float p = P[(ty + 16 * r) * kPLd + k];
#pragma unroll
        for (int c = 0; c < 4; ++c) o[r][c] = fmaf(p, vk[c], o[r][c]);
      }
    }
    __syncthreads();   // the next key block rebuilds L over P and v
  }

  float* zr = z + (size_t)bh * N * dh;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int n = q0 + ty + 16 * r;
    if (n >= N) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = tx + 16 * c;
      if (col < dh) zr[(size_t)n * dh + col] = l[r] > 0.f ? o[r][c] / l[r] : 0.f;
    }
  }
}

template <bool kCausal>
int launch(const float* x, const float* v, const float* lm, const float* th,
           const float* mk, const float* km, const float* hcre,
           const float* hcim, const float* gcre, const float* gcim, float* z,
           int BH, int N, int S, int dh, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      relevance_flash_kernel<kCausal>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nt = (N + kBlk - 1) / kBlk;
  const dim3 grid(BH, nt);
  relevance_flash_kernel<kCausal><<<grid, kThreads, smem, stream>>>(
      x, v, lm, th, mk, km, hcre, hcim, gcre, gcim, z, N, S, dh, nt);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory the kernel needs, in bytes (independent of the shapes).
size_t relevance_flash_smem_bytes() {
  return sizeof(float) *
         (2 * (size_t)kBlk * kDh + 4 * (size_t)kBlk * kLd + 2 * 2 * 2 * kNSeg * kDh);
}

// Launches K2 on `stream` and returns cudaGetLastError() (0 on success).
// Device pointers to contiguous fp32 arrays: x (masked keys zeroed), v,
// z [BH, N, dh]; lm, th, mk [BH, S]; km [BH, N]; hcre, hcim (and gcre, gcim
// when causal == 0) [BH, ceil(N / 128), S, dh], the carries at each 128-row
// block's start (end). Needs 1 <= dh <= 64.
int relevance_flash_launch(const void* x, const void* v, const void* lm,
                           const void* th, const void* mk, const void* km,
                           const void* hcre, const void* hcim, const void* gcre,
                           const void* gcim, void* z, int BH, int N, int S,
                           int dh, int causal, void* stream) {
  const size_t smem = relevance_flash_smem_bytes();
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  if (causal)
    return launch<true>(f(x), f(v), f(lm), f(th), f(mk), f(km), f(hcre), f(hcim),
                        f(gcre), f(gcim), static_cast<float*>(z), BH, N, S, dh,
                        smem, static_cast<cudaStream_t>(stream));
  return launch<false>(f(x), f(v), f(lm), f(th), f(mk), f(km), f(hcre), f(hcim),
                       f(gcre), f(gcim), static_cast<float*>(z), BH, N, S, dh,
                       smem, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
