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
// (query, key) pair (262 GFLOP a causal call at BH = 32, N = 1000, S = 64,
// dh = 64) against a few MB of inputs, so arithmetic bounds it, not memory:
// with P.v, as three TF32 products on the tensor cores, 1.6 ms at
// 495 TFLOP/s. In this design the consumer warpgroup's own instruction
// stream (fragment loads and splits beside 48 wgmma per node) sets the pace.
//
// Precision: 3xTF32 on the tensor cores. Each operand a splits into
// hi = tf32(a) (round to nearest) and lo = a - hi, which the tensor cores
// read truncated to TF32, and the kernel accumulates lo.hi + hi.lo + hi.hi;
// the dropped lo.lo term and lo's truncation are ~2^-21 of the product, so
// the products are close to fp32's (one TF32 product, a 10-bit mantissa,
// misses K2's tolerance: tests/test_torch_k2_precision.py). The sum is not:
// the tensor cores add each k-step into the fp32 accumulator with
// truncation, so over the 3 x 1024 k-steps of a key block the scores shrink
// toward zero, by 25-31x fp32's rounding error (chip_smoke.py phase 2c
// measures it on the card). z stays within K2's tolerances, with the
// kernel's own error, not the plain version's, the larger part where the
// softmax is smooth (phase 2b holds both against a float64 plain version).
// P.v is split the same way.
//
// Design. One block of 384 threads owns (row bh, 64-query block qb) and
// walks the key blocks of 64 (causal: only kb <= qb; the longest query
// blocks launch first), and inside a key block the nodes whose mask is not
// 0. The warpgroups have fixed roles (warp specialisation, setmaxnreg moves
// registers from the producers to the consumer):
//
//  * producers (threads 128-383, two warpgroups): thread (side, seg, d) runs
//    the recurrence of feature column d over one 32-row segment of the query
//    block (side 0) or the key block (side 1), seeded from the carry the host
//    computed at that segment's start (bidirectional: the forward pass stays
//    in registers while the reverse pass runs from the segment-end carry),
//    with x's column in registers and the next node's carries and pole
//    prefetched. It writes node s's operands straight into one of two
//    shared-memory stages:
//      Lq [64 q][128] fp32 (re | im, times mk_s), laid out so that each A
//      fragment loads as float2s, conflict-free;
//      Lk [64 k][128] as tf32 hi and lo, K-major, in the 128-byte swizzle
//      that the wgmma descriptors read.
//    After the last node of a key block they stage v's tile transposed
//    (dh-major over keys, K-major for wgmma) as hi and lo.
//  * consumer (threads 0-127): per node, four commit groups of 4 k-steps;
//    for each it waits for the group before, loads its A fragments of Lq
//    from shared memory, splits them into hi/lo in registers and issues
//    wgmma.m64n64k8.tf32 (A from registers, B = Lk hi/lo by descriptor)
//    into the 64 x 64 score accumulator: 48 products per node. (A second
//    fragment set would overlap the loads with the wgmmas, but costs ptxas
//    the registers to keep the bidirectional kernel's wgmmas asynchronous.) After the node loop: masks, online
//    softmax in registers, and P.v as 3xTF32 wgmma with P taken from the
//    score accumulator (keys permuted within each group of 8 so that the
//    accumulator layout is the A fragment layout).
//
// The stages are handed over by mbarriers (full: the producers' 256 threads
// arrive after a proxy fence; empty: the consumer's 128 arrive once the
// last wgmma group that read the stage has completed), so node s+1's
// recurrence runs while node s is contracted, with no block-wide barrier in
// the loop. Masked nodes are skipped by both roles (their terms are 0).
// TF32 rounding runs on the integer pipe (add and mask), not as a
// conversion, whose unit has a quarter of the rate.
//
// Shared memory: 2 stages x (Lk hi 32 KB + Lk lo 32 KB + Lq 32 KB) = 192 KB,
// v^T hi/lo 32 KB, barriers, and 1 KB to align the swizzled tiles to
// 1024 bytes: 230,464 of the 232,448 bytes a block may use, so one block
// per SM; a 64-row query block gives BH = 8 (batch 1) 128 blocks. The query
// side is rebuilt for every key block (qb + 1 times when causal):
// holding a node's query L across key blocks would take S x 32 KB. That
// work runs in the producers, beside the contraction.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlk = 64;             // query and key rows per block
constexpr int kDh = 64;              // feature columns held (dh <= kDh)
constexpr int kK = 2 * kDh;          // contraction depth per node (re | im)
constexpr int kSeg = 32;             // rows per producer recurrence (and host carry)
constexpr int kThreads = 384;        // one consumer and two producer warpgroups
constexpr int kProducers = kThreads - 128;
constexpr int kProducerRegs = 136;   // registers after setmaxnreg
constexpr int kConsumerRegs = 192;
constexpr float kNeg = -1e30f;

// byte layout of the dynamic shared memory (after 1024-byte alignment)
constexpr int kTile = kBlk * kK * 4;              // 32 KB: one [64][128] fp32 tile
constexpr int kStage = 3 * kTile;                 // Lk hi, Lk lo, Lq
constexpr int kVt = kDh * kBlk * 4;               // 16 KB: v^T hi or lo
constexpr int kBarOff = 2 * kStage + 2 * kVt;
constexpr int kSmemBytes = kBarOff + 64 + 1024;

// ---------------------------------------------------------------------------
// layouts
// ---------------------------------------------------------------------------

// Lq: row-major [64][128] fp32. Within each group of 8 columns, column c
// and c + 4 sit side by side (the pair one A fragment load takes as a
// float2), and the groups are XOR-swizzled by the row, so that the
// consumer's float2 loads and the producer's row stores are conflict-free.
__device__ __forceinline__ int lq_idx(int row, int k) {
  const int p = (k & ~7) | ((k & 3) << 1) | ((k >> 2) & 1);
  return row * kK + (p ^ ((row & 7) << 3));
}

// A K-major wgmma operand [rows][K] fp32 in the 128-byte swizzle: K in
// chunks of 32 (128 bytes), each chunk [rows][32] with 16-byte groups XORed
// by the row within each 8-row, 1024-byte atom. Float index.
__device__ __forceinline__ int kmaj_idx(int row, int k, int rows) {
  return (k >> 5) * (rows * 32) + row * 32 + ((((k & 31) >> 2) ^ (row & 7)) << 2) +
         (k & 3);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma shared-memory descriptor: K-major, 128-byte swizzle, 8-row groups
// 1024 bytes apart.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// descriptor of k-step ks (8 tf32 = 32 bytes) of a K-major operand of `rows`
// rows whose descriptor is `base`: the start address field (16-byte units,
// shared memory < 256 KB) takes the offset without a carry out
__device__ __forceinline__ uint64_t kstep_desc(uint64_t base, int ks, int rows) {
  return base + (uint64_t)(((ks >> 2) * (rows * 128) + (ks & 3) * 32) >> 4);
}

// a rounded to TF32 (nearest, ties away from zero, as cvt.rna.tf32.f32) on
// the integer pipe: both roles split every operand they make, and cvt runs
// on the conversion unit at a quarter of the rate
__device__ __forceinline__ uint32_t tf32(float a) {
  return (__float_as_uint(a) + 0x1000u) & 0xFFFFE000u;
}

// a = hi + lo with hi in TF32; lo = a - hi is exact in fp32 and is passed
// as it is: the tensor cores read a TF32 operand's top 19 bits, so lo
// enters truncated to TF32 (as CUTLASS's fast 3xTF32 does), an error of at
// most 2^-10 |lo| <= 2^-21 |a|
__device__ __forceinline__ void split(float a, uint32_t& hi, uint32_t& lo) {
  hi = tf32(a);
  lo = __float_as_uint(a - __uint_as_float(hi));
}

// ---------------------------------------------------------------------------
// barriers and wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ uint64_t globaltimer_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// wait until the barrier's phase with this parity has completed; a wait of
// more than 20 s traps, so a broken handoff fails the launch, not the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_addr(bar);
  const uint64_t t0 = globaltimer_ns();
  uint32_t done;
  do {
    if (globaltimer_ns() - t0 > 20000000000ull) __trap();
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
}

// shared-memory writes by these threads become visible to wgmma (async proxy)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keep registers that an in-flight wgmma reads or writes where they are
__device__ __forceinline__ void pin(float* d) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int NK>
__device__ __forceinline__ void pin(uint32_t (&a)[NK][4]) {
#pragma unroll
  for (int i = 0; i < NK; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// d[64 x 64] += A[64 x 8] (registers, tf32) * B[8 x 64] (descriptor)
__device__ __forceinline__ void wgmma_tf32(float* d, const uint32_t (&a)[4],
                                           uint64_t desc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// d += 3xTF32 of A (NK k-steps, hi/lo in registers) times B (hi/lo K-major
// operands of 64 rows from k-step ks0)
template <int NK>
__device__ __forceinline__ void wgmma_3x(float* d, const uint32_t (&ahi)[NK][4],
                                         const uint32_t (&alo)[NK][4],
                                         uint64_t bhi, uint64_t blo, int ks0) {
#pragma unroll
  for (int ks = 0; ks < NK; ++ks) {
    const uint64_t dh = kstep_desc(bhi, ks0 + ks, kBlk);
    const uint64_t dl = kstep_desc(blo, ks0 + ks, kBlk);
    wgmma_tf32(d, alo[ks], dh);
    wgmma_tf32(d, ahi[ks], dl);
    wgmma_tf32(d, ahi[ks], dh);
  }
}

// complex z = a * z + x
__device__ __forceinline__ void cstep(float& zr, float& zi, float ar, float ai,
                                      float x) {
  const float r = fmaf(ar, zr, fmaf(-ai, zi, x));
  zi = fmaf(ar, zi, ai * zr);
  zr = r;
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

// wgmma k-position of key kk within its group of 8: the score accumulator
// holds keys 2c and 2c + 1 in a thread where the A fragment wants k-positions
// c and c + 4, so v^T stores key 2c at position c and key 2c + 1 at c + 4.
__device__ __forceinline__ int pv_pos(int kk) {
  return (kk & ~7) | ((kk & 1) << 2) | ((kk & 7) >> 1);
}

template <bool kCausal>
__global__ void __launch_bounds__(kThreads, 1)
relevance_flash_kernel(const float* __restrict__ x, const float* __restrict__ v,
                       const float* __restrict__ lm, const float* __restrict__ th,
                       const float* __restrict__ mk, const float* __restrict__ km,
                       const float* __restrict__ hcre, const float* __restrict__ hcim,
                       const float* __restrict__ gcre, const float* __restrict__ gcim,
                       float* __restrict__ z, int N, int S, int dh, int nt) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kBarOff);
  uint64_t* full = bars;        // [2] the producers filled a stage
  uint64_t* empty = bars + 2;   // [2] the consumer's wgmmas left a stage
  uint64_t* vfull = bars + 4;   // v^T staged
  uint64_t* vempty = bars + 5;  // v^T read
  float* vhi = reinterpret_cast<float*>(smem + 2 * kStage);
  float* vlo = vhi + kVt / 4;

  const int bh = blockIdx.x;
  const int qb = nt - 1 - blockIdx.y;     // longest causal rows first
  const int q0 = qb * kBlk;
  const int kend = kCausal ? qb + 1 : nt;
  const float* mkr = mk + (size_t)bh * S;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&full[i], kProducers);
      mbar_init(&empty[i], 128);
    }
    mbar_init(vfull, kProducers);
    mbar_init(vempty, 128);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // ===== producers: the recurrence, into the wgmma layouts =====
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    const int t = threadIdx.x - 128;
    // thread (side, seg, d): column d of rows seg*32 .. seg*32 + 31 of the
    // query block (side 0) or the key block (side 1)
    const int side = t >> 7, seg = (t >> 6) & 1, d = t & 63;
    const int rs = seg * kSeg;
    const bool act = d < dh;
    const float* xr = x + (size_t)bh * N * dh;
    const float* vr = v + (size_t)bh * N * dh;
    const float* lmr = lm + (size_t)bh * S;
    const float* thr = th + (size_t)bh * S;
    const int ntc = nt * (kBlk / kSeg);     // carries per row of x
    float xv[kSeg];
    auto load_x = [&](int r0) {
#pragma unroll
      for (int i = 0; i < kSeg; ++i)
        xv[i] = (act && r0 + i < N) ? xr[(size_t)(r0 + i) * dh + d] : 0.f;
    };
    // the next node from `s` on whose mask is not 0, and what its
    // recurrence needs; fetched one node ahead so the loads' latency hides
    // behind the current node's recurrence
    struct Node { int s; float mk, lm, th, hr, hi, gr, gi; };
    auto fetch = [&](int s, int cs) {
      Node n{s, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      while (n.s < S && mkr[n.s] == 0.f) ++n.s;   // masked nodes add 0
      if (n.s < S) {
        n.mk = mkr[n.s];
        n.lm = lmr[n.s];
        n.th = thr[n.s];
        const size_t c = (((size_t)bh * ntc + cs) * S + n.s) * dh + d;
        if (act) {
          n.hr = hcre[c]; n.hi = hcim[c];
          if (!kCausal) { n.gr = gcre[c]; n.gi = gcim[c]; }
        }
      }
      return n;
    };
    if (side == 0) load_x(q0 + rs);
    int it = 0;
    for (int kb = 0; kb < kend; ++kb) {
      const int k0 = kb * kBlk;
      const int cs = (side ? kb : qb) * (kBlk / kSeg) + seg;   // this segment's carries
      if (side == 1) load_x(k0 + rs);
      Node nxt = fetch(0, cs);
      while (nxt.s < S) {
        const Node cur = nxt;
        nxt = fetch(cur.s + 1, cs);
        const int st = it & 1;
        float* stage = reinterpret_cast<float*>(smem + st * kStage);
        float* Bhi = stage;
        float* Blo = stage + kTile / 4;
        float* Lq = stage + 2 * (kTile / 4);
        float sinv, cosv;
        sincosf(cur.th, &sinv, &cosv);
        const float mag = expf(cur.lm);
        const float lr = mag * cosv, li = mag * sinv;
        float zr = cur.hr, zi = cur.hi, gr = cur.gr, gi = cur.gi;
        mbar_wait(&empty[st], ((it >> 1) & 1) ^ 1);
        float fr[kSeg], fi[kSeg];   // bidirectional: the forward pass
        if (side == 0) {
          const float fq = kCausal ? cur.mk : 1.f;
#pragma unroll
          for (int i = 0; i < kSeg; ++i) {
            cstep(zr, zi, lr, li, xv[i]);
            if (kCausal) {
              Lq[lq_idx(rs + i, d)] = zr * fq;
              Lq[lq_idx(rs + i, kDh + d)] = zi * fq;
            } else {
              fr[i] = zr; fi[i] = zi;
            }
          }
          if (!kCausal) {   // L = (L_fwd + L_rev - x) * mk
#pragma unroll
            for (int i = kSeg - 1; i >= 0; --i) {
              cstep(gr, gi, lr, li, xv[i]);
              Lq[lq_idx(rs + i, d)] = (fr[i] + gr - xv[i]) * cur.mk;
              Lq[lq_idx(rs + i, kDh + d)] = (fi[i] + gi) * cur.mk;
            }
          }
        } else {
          auto put = [&](int i, float re, float im) {
            const int o = kmaj_idx(rs + i, d, kBlk), oi = kmaj_idx(rs + i, kDh + d, kBlk);
            uint32_t h, l;
            split(re, h, l);
            Bhi[o] = __uint_as_float(h); Blo[o] = __uint_as_float(l);
            split(im, h, l);
            Bhi[oi] = __uint_as_float(h); Blo[oi] = __uint_as_float(l);
          };
#pragma unroll
          for (int i = 0; i < kSeg; ++i) {
            cstep(zr, zi, lr, li, xv[i]);
            if (kCausal) put(i, zr, zi);
            else { fr[i] = zr; fi[i] = zi; }
          }
          if (!kCausal) {   // L = L_fwd + L_rev - x
#pragma unroll
            for (int i = kSeg - 1; i >= 0; --i) {
              cstep(gr, gi, lr, li, xv[i]);
              put(i, fr[i] + gr - xv[i], fi[i] + gi);
            }
          }
        }
        fence_async_smem();
        mbar_arrive(&full[st]);
        ++it;
      }
      // v's key block, transposed and split, for the consumer's P.v
      mbar_wait(vempty, (kb & 1) ^ 1);
      for (int e = t; e < kBlk * kDh; e += kProducers) {
        const int kk = e / kDh, col = e % kDh, n = k0 + kk;
        const float val = (n < N && col < dh) ? vr[(size_t)n * dh + col] : 0.f;
        uint32_t h, l;
        split(val, h, l);
        const int o = kmaj_idx(col, pv_pos(kk), kDh);
        vhi[o] = __uint_as_float(h);
        vlo[o] = __uint_as_float(l);
      }
      fence_async_smem();
      mbar_arrive(vfull);
    }
  } else {
    // ===== consumer: 3xTF32 wgmma, online softmax, P.v =====
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, c = lane & 3;
    const int r0 = 16 * w + g, r1 = r0 + 8;      // block-local rows
    const float scale = 1.0f / sqrtf((float)S);
    const float* kmr = km + (size_t)bh * N;
    // the key block's scores in acc, z's running sum in o
    float acc[32], o[32], m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;
    // A fragments (4 k-steps, hi/lo): one set for the score groups, two for
    // P.v. A second set alternating between score groups would let a group's
    // loads overlap the previous group's wgmmas, but it leaves ptxas too few
    // registers for the bidirectional kernel, which then serializes every
    // wgmma (ptxas warning C7512, which build.py refuses)
    uint32_t ahi0[4][4], alo0[4][4], ahi1[4][4], alo1[4][4];
    auto load_a = [&](const float* Lq, int kbase, uint32_t (&hi)[4][4],
                      uint32_t (&lo)[4][4]) {
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const int k = kbase + 8 * ks + c;   // (row, k) and (row, k + 4) pair up
        const float2 a0 = *reinterpret_cast<const float2*>(Lq + lq_idx(r0, k));
        const float2 a1 = *reinterpret_cast<const float2*>(Lq + lq_idx(r1, k));
        split(a0.x, hi[ks][0], lo[ks][0]);
        split(a1.x, hi[ks][1], lo[ks][1]);
        split(a0.y, hi[ks][2], lo[ks][2]);
        split(a1.y, hi[ks][3], lo[ks][3]);
      }
    };
    int nact = 0;                // nodes whose mask is not 0: stages per key block
    for (int s = 0; s < S; ++s) nact += mkr[s] != 0.f;
    int it = 0, pending = -1;   // pending: the stage the last group reads
    for (int kb = 0; kb < kend; ++kb) {
      const int k0 = kb * kBlk;
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.f;
      for (int j = 0; j < nact; ++j) {
        const int st = it & 1;
        const float* stage = reinterpret_cast<const float*>(smem + st * kStage);
        const uint64_t bhi = make_desc(smem_addr(stage));
        const uint64_t blo = make_desc(smem_addr(stage) + kTile);
        const float* Lq = stage + 2 * (kTile / 4);
        mbar_wait(&full[st], (it >> 1) & 1);
        // four commit groups of 4 k-steps (re 0-31, re 32-63, im 0-31,
        // im 32-63); before a group reloads the fragments, the group before
        // it has completed
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          wgmma_wait<0>();
          pin(acc); pin(ahi0); pin(alo0);
          if (q == 0 && pending >= 0) {   // the previous node's groups are done
            mbar_arrive(&empty[pending]);
            pending = -1;
          }
          load_a(Lq, 32 * q, ahi0, alo0);
          wgmma_fence();
          wgmma_3x<4>(acc, ahi0, alo0, bhi, blo, 4 * q);
          wgmma_commit();
        }
        pending = st;
        ++it;
      }
      wgmma_wait<0>();
      pin(acc); pin(ahi0); pin(alo0);
      if (pending >= 0) mbar_arrive(&empty[pending]);
      pending = -1;

      // online softmax over this key block; thread rows r0 (e < 2), r1
      bool kv[8][2];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const int kc = k0 + 8 * j + 2 * c + b;
          kv[j][b] = kc < N && kmr[kc] > 0.f;
        }
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int qrow = q0 + (h ? r1 : r0);
        float mx = kNeg;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int b = 0; b < 2; ++b) {
            const int kc = k0 + 8 * j + 2 * c + b;
            const bool ok = kv[j][b] && (!kCausal || kc <= qrow);
            float& a = acc[4 * j + 2 * h + b];
            a = ok ? a * scale : kNeg;
            mx = fmaxf(mx, a);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float mnew = fmaxf(m[h], mx);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int b = 0; b < 2; ++b) {
            const int kc = k0 + 8 * j + 2 * c + b;
            const bool ok = kv[j][b] && (!kCausal || kc <= qrow);
            float& a = acc[4 * j + 2 * h + b];
            a = ok ? expf(a - mnew) : 0.f;
            sum += a;
          }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        alpha[h] = expf(m[h] - mnew);
        l[h] = alpha[h] * l[h] + sum;
        m[h] = mnew;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[4 * j + 0] *= alpha[0]; o[4 * j + 1] *= alpha[0];
        o[4 * j + 2] *= alpha[1]; o[4 * j + 3] *= alpha[1];
      }

      // P.v: P from the accumulator as A fragments (see pv_pos)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t (&hi)[4][4] = j < 4 ? ahi0 : ahi1;
        uint32_t (&lo)[4][4] = j < 4 ? alo0 : alo1;
        split(acc[4 * j + 0], hi[j & 3][0], lo[j & 3][0]);
        split(acc[4 * j + 2], hi[j & 3][1], lo[j & 3][1]);
        split(acc[4 * j + 1], hi[j & 3][2], lo[j & 3][2]);
        split(acc[4 * j + 3], hi[j & 3][3], lo[j & 3][3]);
      }
      mbar_wait(vfull, kb & 1);
      pin(o);
      wgmma_fence();
      const uint64_t dvhi = make_desc(smem_addr(vhi)), dvlo = make_desc(smem_addr(vlo));
      wgmma_3x<4>(o, ahi0, alo0, dvhi, dvlo, 0);
      wgmma_3x<4>(o, ahi1, alo1, dvhi, dvlo, 4);
      wgmma_commit();
      wgmma_wait<0>();
      pin(o); pin(ahi0); pin(alo0); pin(ahi1); pin(alo1);
      mbar_arrive(vempty);
    }

    float* zr = z + (size_t)bh * N * dh;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = q0 + (h ? r1 : r0);
      if (n >= N) continue;
      const float inv = l[h] > 0.f ? 1.f / l[h] : 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const int col = 8 * j + 2 * c + b;
          if (col < dh) zr[(size_t)n * dh + col] = o[4 * j + 2 * h + b] * inv;
        }
    }
  }
}

template <bool kCausal>
int launch(const float* x, const float* v, const float* lm, const float* th,
           const float* mk, const float* km, const float* hcre,
           const float* hcim, const float* gcre, const float* gcim, float* z,
           int BH, int N, int S, int dh, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      relevance_flash_kernel<kCausal>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const int nt = (N + kBlk - 1) / kBlk;
  const dim3 grid(BH, nt);
  relevance_flash_kernel<kCausal><<<grid, kThreads, kSmemBytes, stream>>>(
      x, v, lm, th, mk, km, hcre, hcim, gcre, gcim, z, N, S, dh, nt);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory the kernel needs, in bytes (independent of the shapes).
size_t relevance_flash_smem_bytes() { return kSmemBytes; }

// Rows per query and key block: x is padded to a multiple for the carries.
int relevance_flash_block() { return kBlk; }

// Rows between the host's tile carries (a producer's recurrence segment).
int relevance_flash_carry_stride() { return kSeg; }

// Launches K2 on `stream` and returns cudaGetLastError() (0 on success).
// Device pointers to contiguous fp32 arrays: x (masked keys zeroed), v,
// z [BH, N, dh]; lm, th, mk [BH, S]; km [BH, N]; hcre, hcim (and gcre, gcim
// when causal == 0) [BH, 2 * ceil(N / 64), S, dh], the carries at each
// 32-row segment's start (end). Needs 1 <= dh <= 64.
int relevance_flash_launch(const void* x, const void* v, const void* lm,
                           const void* th, const void* mk, const void* km,
                           const void* hcre, const void* hcim, const void* gcre,
                           const void* gcim, void* z, int BH, int N, int S,
                           int dh, int causal, void* stream) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  if (causal)
    return launch<true>(f(x), f(v), f(lm), f(th), f(mk), f(km), f(hcre), f(hcim),
                        f(gcre), f(gcim), static_cast<float*>(z), BH, N, S, dh,
                        static_cast<cudaStream_t>(stream));
  return launch<false>(f(x), f(v), f(lm), f(th), f(mk), f(km), f(hcre), f(hcim),
                       f(gcre), f(gcim), static_cast<float*>(z), BH, N, S, dh,
                       static_cast<cudaStream_t>(stream));
}

}  // extern "C"
