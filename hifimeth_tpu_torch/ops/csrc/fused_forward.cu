// Window gather + the whole DNAModNet forward, written for Hopper (sm_90a):
// v3, on the tensor cores in 3xTF32.
//
// Replaces the Pallas kernel _fused_kernel of the JAX package
// (hifimeth_tpu/ops/fused.py:192, launched by fused_forward at :373).  For
// every planned site it computes the reference DNAModNet forward of that
// site's window and writes only the 2 logits:
//
//   window[c, l] = table[c,       start + l]             (forward)
//   window[c, l] = table[perm[c], start + kmer - 1 - l]  (reverse strand)
//   perm = {3, 2, 1, 0, 6, 7, 4, 5}
//   x0 = window * bn0_scale[c] + bn0_shift[c]
//   x1 = relu(conv1(x0)), K = 11 (CpG/CHG) or 13 (CHH), stride 2, zero pad
//        (1, 1) at the window's edges, after bn0
//   x2..x8 = relu(conv(x)), K = 3, stride 2, zero pad (1, 1)
//   logits = fc2(relu(fc1(flatten(x8)))), flatten channel-major (c * L + l)
//
// Bound: operations.  Per window the products take 22,297,600 FLOP
// (CpG/CHG) or 22,881,280 (CHH), 94% of it in conv1..conv4.  An f32-accurate
// product on this card is three TF32 tensor-core passes, so the least time
// is the FLOP over 495 / 3 = 165 TFLOP/s; the bytes (table span, weights,
// logits) are three orders of magnitude below it.
//
// Precision (3xTF32): each operand x is split into hi = rna(x) and
// lo = rna(x - hi), rna rounding to TF32 as cvt.rna.tf32.f32 does (see
// to_tf32), and every product is accumulated in FP32 as lo*hi + hi*lo +
// hi*hi (the lo*lo term, ~2^-22 relative, is dropped).  No raw f32 bits
// reach a TF32 mma.  bn0 and fc2 stay in FP32 FFMA.
//
// Design:
//   - every conv and fc1 is an implicit GEMM (M = output positions, N =
//     Cout, K = taps x Cin).  Activations are stored position-major: each
//     row holds one padded position's channels, the zero-padded sequence
//     split into an even plane (rows 0..half-1) and an odd plane (rows
//     half..2 half-1), so tap k of output p is row p + (k >> 1) of plane
//     k & 1: a contiguous K-major tile whose rows each thread addresses
//     itself (a GEMM row can be any (site, position) pair).  Rows are
//     Cin + 4 floats, so a fragment's 8 rows x 4 columns fall in 32
//     distinct banks;
//   - conv1..conv4 run on wgmma.m64nNk8 TF32 with A from registers: each
//     warpgroup takes one 64-row M tile times kWgN channels (conv1
//     4 x 128, conv2 2 x 2 x 64, conv3 2 x 2 x 64 over two sites, conv4
//     4 x 24 over two sites), loads its A fragments from the planes and
//     splits them in registers; B is read by descriptor from the weight
//     chunk in shared memory.  Every GEMM's weights are split on the host
//     (ops/fused.py pack_split): chunks of kc K-rows (32; fc1 8), hi then
//     lo, each in the unswizzled K-major core-matrix order (8 channels x 4
//     K-values per 128 bytes), conv1's K zero-padded to whole chunks so no
//     branch surrounds a wgmma (a branch makes ptxas serialise them);
//   - the tail (conv5..conv8, fc1) runs on mma.sync.m16n8k8 TF32 over 8
//     sites at a time (M = 104, 56, 32, 16, 8 instead of 13, 7, 4, 2, 1),
//     from warp tiles of MT x NT mma tiles (kTiling); its weights come
//     split in the same chunk format as the head's, in which an mma's b0
//     and b1 are each one core matrix, lane l reading its float l (no bank
//     conflict), so only A is split in registers; fc2 runs in FP32 with
//     one warp per logit;
//   - weight chunks are streamed through a shared-memory ring (head: 3
//     stages of 32 KB; mid: 2 of 32 KB; tail: 3 of 24 KB): one thread
//     issues cp.async.bulk
//     for a whole chunk against the stage's mbarrier (expect_tx), the warps
//     wait on the barrier's parity, and after a block barrier the freed
//     stage takes the next chunk.  The stream is continuous over layers and
//     sites, so the next layer's first chunk (and the next site's) is in
//     flight during the current layer's last chunk and epilogue.  The
//     ring's counters run over the whole stream, so the parity stays right
//     when it wraps across layers;
//   - three kernels, one launch of the wrapper, each a persistent
//     512-thread CTA per SM walking its items: the head (window + bn0 +
//     conv1 + conv2, one site at a time: conv1's output, 105.6 KB, leaves
//     no room for a second) writes conv2's output planes (53.9 KB a site)
//     to a scratch buffer; the mid kernel runs conv3 and conv4 over two
//     sites at a time, so each weight chunk it streams serves twice the
//     rows, and writes conv4's planes (11.2 KB a site); the tail reads
//     those;
//   - each GEMM's epilogue adds the bias, applies the ReLU and writes the
//     next layer's planes (or fc1's channel-major input) directly, with the
//     pad rows written as zeros; rows of a ragged last M tile read a
//     clamped valid row and are not stored.
//
// What bounds it in practice: every site (every two sites in the mid
// kernel) re-streams the hi/lo weight chunks of conv1..conv4, 1.2 MB a
// site, from L2 into shared memory, and each chunk is used on only 50..200
// rows of M; a CTA waits on each chunk's copy and then runs a short burst
// of wgmma.  The 64-row tiles of conv1 (197 rows in 256) and conv4 (50 in
// 64) are partly padding.  Reusing each chunk for more rows is the next
// step.
//
// Shared memory per CTA: head 3 x 32 KB ring + 105.6 KB (conv1's output)
// + 19.4 KB (the window) = 218.1 KB; mid 2 x 32 KB ring + 107.7 KB (two
// sites' conv2 output) + 54.9 KB (their conv3 output) = 222.8 KB; tail
// 3 x 20 KB ring + 89.6 KB (8 sites' conv4 output, conv6's, fc1's input)
// + 51.2 KB (conv5's, conv7's, fc1's output) = 212.8 KB.  One CTA per SM.
//
// Contract: the geometry in `meta` (checked in parse_net: the shipped
// channel chain, tile capacities, chunking) and windows inside the table;
// lanes outside the table read as 0.
//
// Stage ablation (scripts/profile_fused_layers.py): built with
// -DHM_FUSED_STAGES=n, the kernels stop after stage n (0 = the staged
// window, 1..8 = conv1..conv8, 9 = the whole forward) and write zero
// logits.  The mid kernel runs for n >= 3 and the tail for n >= 5: stage
// 2 includes writing conv2's scratch, stage 3 reading it and the mid
// kernel's launch, stage 5 reading conv4's scratch and the tail's launch.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kChannels = 8;
constexpr int kLayers = 8;
constexpr int kHeadLayers = 2;                  // conv1, conv2: head kernel
constexpr int kWgLayers = 4;                    // conv1..conv4 on wgmma
constexpr int kMidSites = 2;                    // sites per mid item
constexpr int kGemms = kLayers + 1;             // conv1..conv8, fc1
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRowPad = 4;                      // floats after each activation row
constexpr int kHeadStages = 3;                  // head weight ring depth
constexpr int kMidStages = 2;                   // mid weight ring depth
constexpr int kTailStages = 3;                  // tail weight ring depth
constexpr int kHeadKc = 32;                     // K-rows per conv1..conv4 chunk
constexpr int kHeadChunk = 2 * 128 * kHeadKc;   // hi + lo floats, Cout <= 128
constexpr int kTailChunk = 2 * 96 * 32;         // hi + lo floats of a tail chunk
constexpr int kWarpGroups = kThreads / 128;
constexpr int kTailSites = 8;                   // sites per tail item
constexpr int kMaxGroup = 32;
constexpr int kMaxOut = 16;
constexpr size_t kMaxSmem = 232448;             // sm_90 per block

// Per GEMM (conv1..conv8, fc1): the Cin and Cout the kernels are built for
// (a k8 step lies in one tap), K-rows per weight chunk (ops/fused.py
// CHUNK_K packs by these; `meta` repeats them and parse_net checks), and
// for the mma.sync layers the warp tile (MT x NT mma tiles of 16 x 8) with
// up to TPW warp tiles per warp.
struct Tiling {
  int cin, cout, kc, mt, nt, tpw;
};
constexpr Tiling kTiling[kGemms] = {
    {8, 128, kHeadKc, 0, 0, 0},   {128, 128, kHeadKc, 0, 0, 0},
    {128, 128, kHeadKc, 0, 0, 0}, {128, 96, kHeadKc, 0, 0, 0},
    {96, 96, 32, 1, 3, 2},        {96, 96, 32, 1, 3, 1},
    {96, 64, 32, 1, 1, 1},        {64, 64, 32, 1, 1, 1},
    {128, 256, 8, 1, 2, 1}};
// conv1..conv4 run on wgmma instead: each warpgroup takes a 64-row M tile
// times kWgN output channels.
constexpr int kWgN[kWgLayers] = {128, 64, 64, 24};

#ifndef HM_FUSED_STAGES
#define HM_FUSED_STAGES (kLayers + 1)
#endif
// GEMMs each kernel runs under HM_FUSED_STAGES
constexpr int stage_gemms(int first, int count) {
  return HM_FUSED_STAGES <= first           ? 0
         : HM_FUSED_STAGES - first >= count ? count
                                            : HM_FUSED_STAGES - first;
}
constexpr int kHeadGemms = stage_gemms(0, kHeadLayers);
constexpr int kMidGemms = stage_gemms(kHeadLayers, kWgLayers - kHeadLayers);
constexpr int kTailGemms = HM_FUSED_STAGES > kLayers
                               ? kGemms - kWgLayers
                               : stage_gemms(kWgLayers, kLayers - kWgLayers);

struct Gemm {              // one GEMM's packed weights
  int w_off, b_off;        // floats into the weight buffer
  int ktot, n, kc;         // K rows (taps x Cin), Cout, K rows per chunk
  int m_site;              // output rows (positions) per site
};

struct Plane {             // a padded activation: 2 * half rows of rs floats
  int half, rs, site;      // rows per plane, row stride, floats per site
};

// Field order of `meta` (ops/fused.py _meta): the net's scalars, then
// eight ints per convolution.
struct Net {
  int kmer, bn_scale_off, bn_shift_off;
  int fc2_w_off, fc2_b_off, n_out;
  Gemm gemm[kGemms];
  Plane act[kLayers];      // the input of conv1..conv8
  int flat_rs, hid_rs;     // per-site floats of fc1's input and output
  int head_a, head_b, mid_a, mid_b, tail_a, tail_b;   // activation buffers
};
constexpr int kMetaLen = 11 + 8 * kLayers;

__host__ __device__ constexpr int half_len(int len) { return (len + 3) / 2; }

__host__ __device__ constexpr int n_chunks(const Gemm& g) {
  return (g.ktot + g.kc - 1) / g.kc;
}

// ---- PTX wrappers ---------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (10 mantissa bits, ties
// away from zero), with two full-rate integer ops: add half a TF32 ulp to
// the magnitude bits, clear the 13 dropped bits.  The result is an exact
// TF32 value, so the tensor cores' truncation of its low bits is a no-op.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// d += a (16 x 8, row) * b (8 x 8, col); fragments as in the PTX ISA for
// m16n8k8 .tf32: a = {A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4]},
// b = {B[t][g], B[t+4][g]}, d = {D[g][2t], D[g][2t+1], D[g+8][2t],
// D[g+8][2t+1]} with g = lane / 4, t = lane % 4.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void wgmma_n128(float (&d)[64],
                                          const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_n64(float (&d)[32],
                                          const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
      "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_n24(float (&d)[12],
                                          const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11 "
      "}, {%12, %13, %14, %15}, %16, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t desc) {
  if constexpr (N == 128) wgmma_n128(d, a, desc);
  else if constexpr (N == 64) wgmma_n64(d, a, desc);
  else wgmma_n24(d, a, desc);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Descriptor of a K-major, unswizzled B tile in shared memory: 8 x 4
// (N x K) core matrices of 128 contiguous bytes, 128 bytes apart along N
// (SBO) and `lbo` bytes apart along K (LBO).
__device__ __forceinline__ uint64_t b_desc(const float* p, uint32_t lbo) {
  const uint64_t l = lbo, s = 128;
  return ((uint64_t)(smem_u32(p) >> 4) & 0x3fff) | ((l >> 4) & 0x3fff) << 16 |
         ((s >> 4) & 0x3fff) << 32;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// One thread: expect `bytes` on `bar`, then copy them global -> shared.
__device__ __forceinline__ void bulk_load(float* dst, const float* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ---- the weight ring --------------------------------------------------------

// Streams the weight chunks of gemms[0..n_gemms) once per item, `items`
// times, through `stages` shared-memory stages of `stage_floats`.  Every
// thread calls wait() and release() in the same order; thread 0 issues
// the copies.
struct Ring {
  float* buf;
  uint64_t* full;
  const Gemm* gemms;
  const float* wts;
  int stages, stage_floats;
  int n_gemms, total, issued, consumed;
  int g, c;                                 // next chunk to issue

  __device__ void start(float* b, uint64_t* f, int n_stages, int floats,
                        const Gemm* gs, int ng, const float* w, int items) {
    buf = b, full = f, stages = n_stages, stage_floats = floats;
    gemms = gs, wts = w, n_gemms = ng;
    int per_item = 0;
    for (int i = 0; i < ng; ++i) per_item += n_chunks(gs[i]);
    total = per_item * items, issued = consumed = 0, g = c = 0;
    if (threadIdx.x == 0) {
      for (int s = 0; s < stages; ++s) mbar_init(&full[s], 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x == 0)
      while (issued < total && issued < stages) issue();
  }

  // A chunk: hi then lo, each Cout x kc, all whole (K zero-padded).
  __device__ void issue() {
    const Gemm& G = gemms[g];
    const int floats = 2 * G.n * G.kc;
    const int s = issued % stages;
    bulk_load(buf + s * stage_floats, wts + G.w_off + (size_t)c * floats,
              (uint32_t)(floats * sizeof(float)), &full[s]);
    ++issued;
    if (++c == n_chunks(G)) {
      c = 0;
      if (++g == n_gemms) g = 0;
    }
  }

  __device__ const float* wait() {
    const int s = consumed % stages;
    mbar_wait(&full[s], (uint32_t)((consumed / stages) & 1));
    return buf + s * stage_floats;
  }

  // After every thread is done with the current stage: refill it.
  __device__ void release() {
    __syncthreads();
    ++consumed;
    if (threadIdx.x == 0 && issued < total) issue();
  }
};

// ---- one GEMM layer ----------------------------------------------------------

struct Src {               // A: row m = (site m / m_site, position m % m_site)
  const float* p;
  Plane pl;
  int rows;                // valid GEMM rows
};

enum { kToPlanes, kToFlat, kToRows };

struct Dst {
  float* p;
  Plane pl;                // kToFlat / kToRows: only pl.site is read
  int rows;                // GEMM rows to store (<= the rows computed)
};

// Output row m (site m / m_site, position m % m_site), channels n, n + 1:
// relu(v + bias) into D's layout.
template <int MODE>
__device__ __forceinline__ void store_pair(const Dst& D, const Gemm& G,
                                           const float* bias, int m, int n,
                                           float v0, float v1) {
  const int s = m / G.m_site, p = m - s * G.m_site;
  float* site_out = D.p + s * D.pl.site;
  v0 = fmaxf(v0 + __ldg(bias + n), 0.f);
  v1 = fmaxf(v1 + __ldg(bias + n + 1), 0.f);
  if (MODE == kToPlanes) {
    const int q = p + 1;                 // padded lane of output p
    *reinterpret_cast<float2*>(
        site_out + ((q & 1) * D.pl.half + (q >> 1)) * D.pl.rs + n) =
        make_float2(v0, v1);
  } else if (MODE == kToFlat) {
    site_out[n * G.m_site + p] = v0;
    site_out[(n + 1) * G.m_site + p] = v1;
  } else {
    *reinterpret_cast<float2*>(site_out + n) = make_float2(v0, v1);
  }
}

// The pad lanes 0 and m_site + 1 of each stored site's output planes;
// then a block barrier ends the layer.
template <int MODE>
__device__ __forceinline__ void finish_layer(const Dst& D, const Gemm& G) {
  if (MODE == kToPlanes) {
    const int sites = D.rows / G.m_site;
    for (int i = threadIdx.x; i < sites * 2 * G.n; i += kThreads) {
      const int s = i / (2 * G.n), r = i - s * 2 * G.n;
      const int q = r < G.n ? 0 : G.m_site + 1, n = r < G.n ? r : r - G.n;
      D.p[s * D.pl.site + ((q & 1) * D.pl.half + (q >> 1)) * D.pl.rs + n] =
          0.f;
    }
  }
  __syncthreads();
}

// out = relu(A * W + b) for one tail conv (or fc1) over the activation in
// `A` on mma.sync, weights from the ring: b0 = B[t][g] and b1 = B[t + 4][g]
// of n-tile j are float `lane` of two core matrices of the chunk's hi and
// lo halves.  Ends with a block barrier.
template <int L, int MODE>
__device__ void gemm_layer(const Gemm& G, const Src& A, const Dst& D,
                           Ring& R) {
  constexpr int CIN = kTiling[L].cin, KC = kTiling[L].kc;
  constexpr int MT = kTiling[L].mt, NT = kTiling[L].nt, TPW = kTiling[L].tpw;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wtn = G.n / (8 * NT);
  const int wtiles = ((A.rows + 16 * MT - 1) / (16 * MT)) * wtn;
  float acc[TPW][MT][NT][4];
  int row[TPW][MT][2];
  int m0[TPW], n0[TPW];
  bool on[TPW];
#pragma unroll
  for (int w = 0; w < TPW; ++w) {
    const int id = warp + w * kWarps;
    on[w] = id < wtiles;
    m0[w] = (id / wtn) * 16 * MT;
    n0[w] = (id % wtn) * 8 * NT;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = min(m0[w] + 16 * i + g + 8 * h, A.rows - 1);
        const int s = m / G.m_site, p = m - s * G.m_site;
        row[w][i][h] = s * A.pl.site + p * A.pl.rs + t;
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[w][i][j][e] = 0.f;
    }
  }

  const int chunks = n_chunks(G);
  for (int c = 0; c < chunks; ++c) {
    const float* hi = R.wait();
    const float* lo = hi + G.n * KC;
#pragma unroll
    for (int s8 = 0; s8 < KC; s8 += 8) {
      const int kg = c * KC + s8, tap = kg / CIN, ci = kg - tap * CIN;
      const float* a_src =
          A.p + ((tap & 1) * A.pl.half + (tap >> 1)) * A.pl.rs + ci;
#pragma unroll
      for (int w = 0; w < TPW; ++w) {
        if (!on[w]) continue;
        uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int o = ((s8 >> 2) * (G.n >> 3) + (n0[w] >> 3) + j) * 32 + lane;
          bh[j][0] = __float_as_uint(hi[o]);
          bh[j][1] = __float_as_uint(hi[o + 4 * G.n]);
          bl[j][0] = __float_as_uint(lo[o]);
          bl[j][1] = __float_as_uint(lo[o + 4 * G.n]);
        }
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          uint32_t ah[4], al[4];
          split(a_src[row[w][i][0]], ah[0], al[0]);
          split(a_src[row[w][i][1]], ah[1], al[1]);
          split(a_src[row[w][i][0] + 4], ah[2], al[2]);
          split(a_src[row[w][i][1] + 4], ah[3], al[3]);
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            mma_tf32(acc[w][i][j], al, bh[j][0], bh[j][1]);
            mma_tf32(acc[w][i][j], ah, bl[j][0], bl[j][1]);
            mma_tf32(acc[w][i][j], ah, bh[j][0], bh[j][1]);
          }
        }
      }
    }
    R.release();
  }

  // epilogue: bias + ReLU into the next layer's layout
  const float* bias = R.wts + G.b_off;
#pragma unroll
  for (int w = 0; w < TPW; ++w) {
    if (!on[w]) continue;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0[w] + 16 * i + g + 8 * h;
        if (m >= D.rows) continue;
#pragma unroll
        for (int j = 0; j < NT; ++j)
          store_pair<MODE>(D, G, bias, m, n0[w] + 8 * j + 2 * t,
                           acc[w][i][j][2 * h], acc[w][i][j][2 * h + 1]);
      }
  }
  finish_layer<MODE>(D, G);
}

// out = relu(A * W + b) for one head conv on wgmma: warpgroup wg takes the
// 64-row M tile wg / (n / NW) times NW channels.  A fragments come from
// each thread's rows of the activation planes, split in registers; B is
// the chunk's hi and lo halves in the ring, read through descriptors.
// Every warpgroup has a tile (parse_net) and every chunk is whole, so no
// branch surrounds a wgmma (which would serialise them).  Ends with a
// block barrier.
template <int L, int MODE>
__device__ void gemm_head(const Gemm& G, const Src& A, const Dst& D,
                          Ring& R) {
  constexpr int CIN = kTiling[L].cin, NW = kWgN[L];
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wtn = G.n / NW;
  const int n0 = (wg % wtn) * NW, m0 = (wg / wtn) * 64 + 16 * warp;
  int row[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = min(m0 + g + 8 * h, A.rows - 1);
    const int s = m / G.m_site, p = m - s * G.m_site;
    row[h] = s * A.pl.site + p * A.pl.rs + t;
  }
  float acc[NW / 2];
#pragma unroll
  for (int e = 0; e < NW / 2; ++e) acc[e] = 0.f;
  const uint32_t lbo = G.n / 8 * 128;    // bytes between K-adjacent cores

  const int chunks = n_chunks(G);
  for (int c = 0; c < chunks; ++c) {
    const float* hi = R.wait();
    const float* lo = hi + G.n * kHeadKc;
    uint32_t ah[kHeadKc / 8][4], al[kHeadKc / 8][4];
#pragma unroll
    for (int s8 = 0; s8 < kHeadKc / 8; ++s8) {
      // K-rows past the layer's (zero weights) read finite stale rows
      const int kg = c * kHeadKc + 8 * s8, tap = kg / CIN;
      const float* a_src = A.p +
          ((tap & 1) * A.pl.half + (tap >> 1)) * A.pl.rs + kg - tap * CIN;
      split(a_src[row[0]], ah[s8][0], al[s8][0]);
      split(a_src[row[1]], ah[s8][1], al[s8][1]);
      split(a_src[row[0] + 4], ah[s8][2], al[s8][2]);
      split(a_src[row[1] + 4], ah[s8][3], al[s8][3]);
    }
    wgmma_fence();
#pragma unroll
    for (int s8 = 0; s8 < kHeadKc / 8; ++s8) {
      const int off = (2 * s8 * (G.n / 8) + n0 / 8) * 32;
      wgmma_tf32<NW>(acc, al[s8], b_desc(hi + off, lbo));
      wgmma_tf32<NW>(acc, ah[s8], b_desc(lo + off, lbo));
      wgmma_tf32<NW>(acc, ah[s8], b_desc(hi + off, lbo));
    }
    wgmma_commit();
    wgmma_wait0();
    R.release();
  }

  const float* bias = R.wts + G.b_off;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + g + 8 * h;
    if (m >= D.rows) continue;
#pragma unroll
    for (int j = 0; j < NW / 8; ++j)
      store_pair<MODE>(D, G, bias, m, n0 + 8 * j + 2 * t, acc[4 * j + 2 * h],
                       acc[4 * j + 2 * h + 1]);
  }
  finish_layer<MODE>(D, G);
}

__device__ __forceinline__ int items_of_block(int n_items) {
  return n_items > (int)blockIdx.x
             ? (n_items - (int)blockIdx.x + (int)gridDim.x - 1) / gridDim.x
             : 0;
}

// ---- the kernels ---------------------------------------------------------------

// Per site: window + bn0 + conv1 + conv2; conv2's output planes go to
// scratch2[site * act[2].site ...].
__global__ void __launch_bounds__(kThreads, 1)
fused_head_kernel(const float* __restrict__ table, int64_t n_cols,
                  const int32_t* __restrict__ bases,
                  const int32_t* __restrict__ rels, int group, int rev,
                  int n_sites, const float* __restrict__ wts,
                  const __grid_constant__ Net net,
                  float* __restrict__ scratch2, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  float* buf_a = ring + kHeadStages * kHeadChunk;
  float* buf_b = buf_a + net.head_a;
  uint64_t* full = reinterpret_cast<uint64_t*>(buf_b + net.head_b);
  // conv1's K-rows padded to whole chunks read stale activation rows
  // (times zero weights): start them finite
  for (int i = threadIdx.x; i < net.head_a + net.head_b; i += kThreads)
    buf_a[i] = 0.f;
  Ring R;
  R.start(ring, full, kHeadStages, kHeadChunk, net.gemm, kHeadGemms, wts,
          items_of_block(n_sites));

  const int kmer = net.kmer;
  const Plane& P0 = net.act[0];
  for (int site = blockIdx.x; site < n_sites; site += gridDim.x) {
    const int64_t start = (int64_t)bases[site / group] + rels[site];
    // the window with bn0 applied into buf_b, position-major planes
    for (int i = threadIdx.x; i < kChannels * kmer; i += kThreads) {
      const int c = i / kmer, l = i - c * kmer;
      const int tc = rev ? (c < 4 ? 3 - c : c ^ 2) : c;
      const int64_t lane = start + (rev ? kmer - 1 - l : l);
      const float v = (lane >= 0 && lane < n_cols)
                          ? __ldg(table + tc * n_cols + lane) : 0.f;
      const int q = l + 1;
      buf_b[((q & 1) * P0.half + (q >> 1)) * P0.rs + c] =
          fmaf(v, __ldg(wts + net.bn_scale_off + c),
               __ldg(wts + net.bn_shift_off + c));
    }
    if (threadIdx.x < 2 * kChannels) {
      const int q = threadIdx.x < kChannels ? 0 : kmer + 1;
      buf_b[((q & 1) * P0.half + (q >> 1)) * P0.rs +
            (threadIdx.x & (kChannels - 1))] = 0.f;
    }
    __syncthreads();

    const Gemm* G = net.gemm;
    const int m1 = G[0].m_site, m2 = G[1].m_site;
    if (kHeadGemms >= 1)
      gemm_head<0, kToPlanes>(G[0], Src{buf_b, P0, m1},
                              Dst{buf_a, net.act[1], m1}, R);
    if (kHeadGemms >= 2)
      gemm_head<1, kToPlanes>(
          G[1], Src{buf_a, net.act[1], m2},
          Dst{scratch2 + (size_t)site * net.act[2].site, net.act[2], m2}, R);
    if (HM_FUSED_STAGES <= kHeadLayers && threadIdx.x < net.n_out)
      out[(size_t)site * net.n_out + threadIdx.x] = 0.f;
  }
}

// Per kMidSites sites: conv3 and conv4 from the head's conv2 planes
// (scratch2) into conv4's planes (scratch4).  A last item with fewer sites
// computes a copy of its first site in the free slot and stores nothing of
// it, so every warpgroup keeps its wgmma tile.
__global__ void __launch_bounds__(kThreads, 1)
fused_mid_kernel(const float* __restrict__ scratch2, int n_sites,
                 const float* __restrict__ wts,
                 const __grid_constant__ Net net,
                 float* __restrict__ scratch4, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  float* buf_a = ring + kMidStages * kHeadChunk;
  float* buf_b = buf_a + net.mid_a;
  uint64_t* full = reinterpret_cast<uint64_t*>(buf_b + net.mid_b);
  const int n_items = (n_sites + kMidSites - 1) / kMidSites;
  Ring R;
  R.start(ring, full, kMidStages, kHeadChunk, net.gemm + kHeadLayers,
          kMidGemms, wts, items_of_block(n_items));

  const Gemm* G = net.gemm;
  const Plane& P2 = net.act[2];
  const int m3 = G[2].m_site, m4 = G[3].m_site;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int site0 = item * kMidSites;
    const int ns = min(kMidSites, n_sites - site0);
    const int q2 = P2.site / 4;              // float4s per site
    for (int i = threadIdx.x; i < kMidSites * q2; i += kThreads) {
      const int s = min(i / q2, ns - 1);
      reinterpret_cast<float4*>(buf_a)[i] = reinterpret_cast<const float4*>(
          scratch2 + (size_t)(site0 + s) * P2.site)[i % q2];
    }
    __syncthreads();

    if (kMidGemms >= 1)
      gemm_head<2, kToPlanes>(G[2], Src{buf_a, P2, kMidSites * m3},
                              Dst{buf_b, net.act[3], kMidSites * m3}, R);
    if (kMidGemms >= 2)
      gemm_head<3, kToPlanes>(
          G[3], Src{buf_b, net.act[3], kMidSites * m4},
          Dst{scratch4 + (size_t)site0 * net.act[4].site, net.act[4],
              ns * m4},
          R);
    if (HM_FUSED_STAGES > kHeadLayers && HM_FUSED_STAGES <= kWgLayers &&
        threadIdx.x < ns * net.n_out)
      out[(size_t)site0 * net.n_out + threadIdx.x] = 0.f;
  }
}

// Per kTailSites sites: conv5..conv8, fc1 and fc2 from scratch4.
__global__ void __launch_bounds__(kThreads, 1)
fused_tail_kernel(const float* __restrict__ scratch4, int n_sites,
                  const float* __restrict__ wts,
                  const __grid_constant__ Net net, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  float* buf_a = ring + kTailStages * kTailChunk;
  float* buf_b = buf_a + net.tail_a;
  uint64_t* full = reinterpret_cast<uint64_t*>(buf_b + net.tail_b);
  const int n_items = (n_sites + kTailSites - 1) / kTailSites;
  Ring R;
  R.start(ring, full, kTailStages, kTailChunk, net.gemm + kWgLayers,
          kTailGemms, wts, items_of_block(n_items));

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Gemm* G = net.gemm;
  const Plane flat{0, 0, net.flat_rs}, hid{0, 0, net.hid_rs};
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int site0 = item * kTailSites;
    const int ns = min(kTailSites, n_sites - site0);
    const int q4 = net.act[4].site / 4;      // float4s per site
    const float4* src =
        reinterpret_cast<const float4*>(scratch4 + (size_t)site0 * 4 * q4);
    for (int i = threadIdx.x; i < ns * q4; i += kThreads)
      reinterpret_cast<float4*>(buf_a)[i] = src[i];
    __syncthreads();

    if (kTailGemms >= 1)
      gemm_layer<4, kToPlanes>(G[4], Src{buf_a, net.act[4], ns * G[4].m_site},
                               Dst{buf_b, net.act[5], ns * G[4].m_site}, R);
    if (kTailGemms >= 2)
      gemm_layer<5, kToPlanes>(G[5], Src{buf_b, net.act[5], ns * G[5].m_site},
                               Dst{buf_a, net.act[6], ns * G[5].m_site}, R);
    if (kTailGemms >= 3)
      gemm_layer<6, kToPlanes>(G[6], Src{buf_a, net.act[6], ns * G[6].m_site},
                               Dst{buf_b, net.act[7], ns * G[6].m_site}, R);
    if (kTailGemms >= 4)
      gemm_layer<7, kToFlat>(G[7], Src{buf_b, net.act[7], ns * G[7].m_site},
                             Dst{buf_a, flat, ns * G[7].m_site}, R);
    if (kTailGemms >= 5)
      gemm_layer<8, kToRows>(G[8], Src{buf_a, flat, ns}, Dst{buf_b, hid, ns},
                             R);
    if (HM_FUSED_STAGES <= kLayers) {
      if (threadIdx.x < ns * net.n_out)
        out[(size_t)site0 * net.n_out + threadIdx.x] = 0.f;
      continue;
    }
    // fc2 in FP32: one warp per (site, logit)
    for (int pair = warp; pair < ns * net.n_out; pair += kWarps) {
      const int s = pair / net.n_out, o = pair - s * net.n_out;
      const float* h = buf_b + s * net.hid_rs;
      float acc = 0.f;
      for (int i = lane; i < G[8].n; i += 32)
        acc = fmaf(__ldg(wts + net.fc2_w_off + i * net.n_out + o), h[i], acc);
      for (int d = 16; d > 0; d >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, d);
      if (lane == 0)
        out[(size_t)(site0 + s) * net.n_out + o] =
            acc + __ldg(wts + net.fc2_b_off + o);
    }
  }
}

// ---- host side ---------------------------------------------------------------

// Whether GEMM l's output tiles for `rows` rows and n channels fit its
// tiling: one 64-row x kWgN tile per warpgroup (conv1..conv4), kTiling's
// warp tiles over the warps (tail).
bool fits(int l, int rows, int n) {
  const Tiling& T = kTiling[l];
  if (n != T.cout) return false;
  if (l < kWgLayers)
    return n % kWgN[l] == 0 &&
           (rows + 63) / 64 * (n / kWgN[l]) == kWarpGroups;
  if (n % (8 * T.nt)) return false;
  const int mtiles = (rows + 15) / 16;
  return ((mtiles + T.mt - 1) / T.mt) * (n / (8 * T.nt)) <= kWarps * T.tpw;
}

// Chunks of kTiling's depth that fit their kernel's stage; only conv1's K
// is zero-padded to whole chunks (its padded taps read the window buffer,
// sized for them in parse_net).
bool chunk_ok(const Gemm& g, int l) {
  return g.kc == kTiling[l].kc && g.ktot % 8 == 0 && g.w_off % 4 == 0 &&
         g.w_off >= 0 && g.b_off >= 0 && (l == 0 || g.ktot % g.kc == 0) &&
         2 * g.n * g.kc <= (l < kWgLayers ? kHeadChunk : kTailChunk);
}

Plane plane(int len, int cin) {
  const int half = half_len(len), rs = cin + kRowPad;
  return Plane{half, rs, 2 * half * rs};
}

// Parse and check `meta`; fills `net` (with its buffer sizes) or returns
// false.
bool parse_net(const int32_t* meta, int n_meta, Net* net) {
  if (n_meta != kMetaLen) return false;
  const int32_t* m = meta;
  net->kmer = *m++;
  net->bn_scale_off = *m++;
  net->bn_shift_off = *m++;
  Gemm& fc1 = net->gemm[kLayers];
  fc1.w_off = *m++;
  fc1.b_off = *m++;
  fc1.ktot = *m++;
  fc1.n = *m++;
  fc1.kc = *m++;
  fc1.m_site = 1;
  net->fc2_w_off = *m++;
  net->fc2_b_off = *m++;
  net->n_out = *m++;
  int cin = kChannels, lin = net->kmer;
  for (int l = 0; l < kLayers; ++l) {
    Gemm& G = net->gemm[l];
    const int k = *m++, c_in = *m++, cout = *m++, l_in = *m++, lout = *m++;
    G.w_off = *m++;
    G.b_off = *m++;
    G.kc = *m++;
    G.ktot = k * c_in;
    G.n = cout;
    G.m_site = lout;
    const bool k_ok = l == 0 ? (k == 11 || k == 13) : k == 3;
    const int rows = l < kHeadLayers ? lout
                     : l < kWgLayers ? kMidSites * lout
                                     : kTailSites * lout;
    if (!k_ok || c_in != cin || c_in != kTiling[l].cin || l_in != lin ||
        lout != (lin + 2 - k) / 2 + 1 || lout < 1 || !fits(l, rows, cout) ||
        !chunk_ok(G, l))
      return false;
    net->act[l] = plane(lin, cin);
    cin = cout;
    lin = lout;
  }
  if (fc1.ktot != cin * lin || fc1.ktot != kTiling[kLayers].cin ||
      !fits(kLayers, kTailSites, fc1.n) || !chunk_ok(fc1, kLayers) ||
      net->n_out < 1 || net->n_out > kMaxOut)
    return false;
  net->flat_rs = fc1.ktot + kRowPad;
  net->hid_rs = fc1.n + kRowPad;
  // head: A holds conv1's output, B the window; a[2] and a[4] are the
  // scratch layouts; mid: A holds two sites of a[2], B of a[3]
  const Plane* a = net->act;
  auto up4 = [](int v) { return (v + 3) & ~3; };   // keep 16-byte alignment
  net->head_a = up4(a[1].site);
  // conv1's K padded to whole chunks reads taps past K1: rows up to the
  // odd plane's half + lout - 1 + (last tap >> 1) must lie in B
  const Gemm& g1 = net->gemm[0];
  const int last_tap = (n_chunks(g1) * g1.kc) / kChannels - 1;
  const int rows0 = a[0].half + g1.m_site + (last_tap >> 1);
  net->head_b = up4(a[0].site > rows0 * a[0].rs ? a[0].site
                                                 : rows0 * a[0].rs);
  net->mid_a = up4(kMidSites * a[2].site);
  net->mid_b = up4(kMidSites * a[3].site);
  const int t4 = kTailSites * a[4].site, t6 = kTailSites * a[6].site;
  const int tf = kTailSites * net->flat_rs;
  net->tail_a = up4(t4 > t6 ? (t4 > tf ? t4 : tf) : (t6 > tf ? t6 : tf));
  const int t5 = kTailSites * a[5].site, t7 = kTailSites * a[7].site;
  const int th = kTailSites * net->hid_rs;
  net->tail_b = up4(t5 > t7 ? (t5 > th ? t5 : th) : (t7 > th ? t7 : th));
  return true;
}

// the weight ring, the activations, the ring's mbarriers
size_t head_smem_bytes(const Net& net) {
  return sizeof(float) * ((size_t)kHeadStages * kHeadChunk + net.head_a +
                          net.head_b) +
         kHeadStages * sizeof(uint64_t);
}

size_t mid_smem_bytes(const Net& net) {
  return sizeof(float) * ((size_t)kMidStages * kHeadChunk + net.mid_a +
                          net.mid_b) +
         kMidStages * sizeof(uint64_t);
}

size_t tail_smem_bytes(const Net& net) {
  return sizeof(float) * ((size_t)kTailStages * kTailChunk + net.tail_a +
                          net.tail_b) +
         kTailStages * sizeof(uint64_t);
}

}  // namespace

// Floats of device scratch the kernels need per site (conv2's and conv4's
// output planes), or -1 if `meta` is not a geometry they take.
extern "C" int64_t hm_fused_scratch_floats(const int32_t* meta, int n_meta) {
  Net net;
  return parse_net(meta, n_meta, &net) ? net.act[2].site + net.act[4].site
                                        : -1;
}

// Plain C entry point for ctypes.  table (8, n_cols) f32; bases (n_groups,)
// and rels (n_groups, group) int32; weights and meta as packed by
// ops/fused.py (weights 16-byte aligned); scratch at least n_groups * group
// * hm_fused_scratch_floats floats; out (n_groups * group, n_out) f32.
// Launches the three kernels on `stream`, does not synchronise, allocates
// nothing; returns a cudaError_t (0 = launched).
extern "C" int hm_fused_forward(const float* table, int64_t n_cols,
                                const int32_t* bases, const int32_t* rels,
                                int n_groups, int group, int rev,
                                const float* weights, const int32_t* meta,
                                int n_meta, float* scratch, float* out,
                                void* stream) {
  if (n_groups <= 0) return (int)cudaSuccess;
  Net net;
  if (group < 1 || group > kMaxGroup || !parse_net(meta, n_meta, &net) ||
      reinterpret_cast<uintptr_t>(weights) % 16 ||
      reinterpret_cast<uintptr_t>(scratch) % 16)
    return (int)cudaErrorInvalidValue;
  const size_t head_smem = head_smem_bytes(net);
  const size_t mid_smem = mid_smem_bytes(net);
  const size_t tail_smem = tail_smem_bytes(net);
  if (head_smem > kMaxSmem || mid_smem > kMaxSmem || tail_smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_sites = n_groups * group;

  e = cudaFuncSetAttribute(fused_head_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)head_smem);
  if (e != cudaSuccess) return (int)e;
  fused_head_kernel<<<n_sites < sms ? n_sites : sms, kThreads, head_smem,
                      s>>>(table, n_cols, bases, rels, group, rev, n_sites,
                           weights, net, scratch, out);
  e = cudaGetLastError();
  if (e != cudaSuccess || HM_FUSED_STAGES <= kHeadLayers) return (int)e;

  float* scratch4 = scratch + (size_t)n_sites * net.act[2].site;
  e = cudaFuncSetAttribute(fused_mid_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)mid_smem);
  if (e != cudaSuccess) return (int)e;
  const int n_mid = (n_sites + kMidSites - 1) / kMidSites;
  fused_mid_kernel<<<n_mid < sms ? n_mid : sms, kThreads, mid_smem, s>>>(
      scratch, n_sites, weights, net, scratch4, out);
  e = cudaGetLastError();
  if (e != cudaSuccess || HM_FUSED_STAGES <= kWgLayers) return (int)e;

  e = cudaFuncSetAttribute(fused_tail_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)tail_smem);
  if (e != cudaSuccess) return (int)e;
  const int n_items = (n_sites + kTailSites - 1) / kTailSites;
  fused_tail_kernel<<<n_items < sms ? n_items : sms, kThreads, tail_smem,
                      s>>>(scratch4, n_sites, weights, net, out);
  return (int)cudaGetLastError();
}
