// Row-major window gathers over an (n_rows, C) float32 table, written for
// Hopper (sm_90a).
//
// Replaces three Pallas kernels of the JAX package
// (hifimeth_tpu/ops/gather.py), which the window-fetch microbenchmark
// drives (scripts/microbench_torch_gather.py):
//
//   group_windows (:197):  out[g*G + t] = feats[b_g + r_gt : + kmer]
//                          b_g  = clamp(bases[g], 0, n_rows - block_rows)
//                          r_gt = clamp(rels[g, t], 0, block_rows - kmer)
//   window_slices (:134):  out[i] = feats[s_i : s_i + kmer]
//                          s_i  = clamp(starts[i], 0, n_rows - kmer)
//   window_rows   (:81):   out[i, j] = T_i[s_i + 2j],  j < out_rows
//                          T_i  = is_rev[i] ? dr_table : d_table
//                          s_i  = clamp(starts[i], 0, n_rows - fetch_rows)
//
// The clamps are lax.dynamic_slice's semantics for a start outside the
// table, so no kernel reads outside it; the plain versions in
// ops/gather.py clamp the same way.
//
// Bound: all three are pure copies, so bytes bound them.  At the
// microbenchmark's shape (16384 sites, kmer 401, C 8) each writes 210 MB of
// windows; window_slices and window_rows read up to half as much again of
// distinct table rows (random starts), group_windows only ~1.3 MB (32
// position-sorted sites ~2.5 rows apart share one ~480-row span).  Rows of
// 8 float32 are 32 B, so group_windows and window_slices move 16-byte
// vectors with consecutive lanes on consecutive addresses (scalar copies
// where C % 4 != 0 or a pointer is not 16-byte aligned):
//   - window_slices: one warp per site streams its window, one contiguous
//     span of kmer*C floats in and out, with four loads in flight per lane
//     before their stores;
//   - group_windows: one CTA per group reduces the group's clamped rels to
//     the span [min r, max r + kmer) of its block, stages exactly that span
//     once in shared memory (at most block_rows rows), then writes the
//     group's windows, which are contiguous in the output, from shared
//     memory with coalesced stores.
// The Pallas grids (spp sites per step, one block DMA per group with double
// buffering) were the TPU's way to keep DMAs in flight and are not carried
// over: here many warps in flight on every SM do that.
//
// window_rows has two routes, which the caller picks (ops/gather.py
// window_rows_route) and passes in; neither gives way to the other.
//   - TMA (C % 4 == 0, C <= 256, 16-byte aligned pointers, two stages of
//     one site's rows within the ring the caller sizes): viewed as (n_rows / 2, 2C)
//     row pairs, a site's rows s, s+2, ... are pairs s/2, s/2 + 1, ... at
//     column (s & 1) * C, width C: a 2-D box.  A tensor map per table over
//     that view lets the Tensor Memory Accelerator land a site's rows
//     densely in shared memory (n_box boxes of R rows, R <= 256 and R*C*4 a
//     multiple of 128 bytes so every box stays 128-byte aligned; rows past
//     out_rows are loaded and never stored, rows past the view are zero
//     fill), and one cp.async.bulk store writes the site's out_rows*C
//     floats, which are contiguous in the output.  No thread touches the
//     data.  Persistent one-warp CTAs take the sites from a shared counter;
//     one thread per CTA keeps a ring of stages of TMA loads in flight
//     (enough bytes per SM for the memory's latency) and stores each stage
//     when its mbarrier flips.  The row pair view reads every row the
//     function reads: the last one is s + 2(out_rows - 1) <= n_rows - 2, so
//     an odd table's last row, which no pair holds, is never read.
//   - scalar: one warp per site reads rows s, s+2, ... float by float.
// The DRAM moves 64-byte bursts (scripts/probe_window_rows.py: reading every
// other 32-byte row of a table costs as much as reading every row), so a
// site's rows cost whole row pairs, twice the bytes it stores, and the
// pairs of overlapping windows (random starts overlap ~1.6 times at the
// microbenchmark's density) are worth fetching once.  In the callers'
// order L2 (50 MB, against two 128 MB tables) keeps almost none of them,
// and the copy ran at the speed of fetching every site's pairs from DRAM.
// So the TMA route first sorts the sites by (strand, start) in a small
// kernel and walks them in that order: overlapping windows then run at
// about the same time and share their pairs in L2, and the tensor maps
// ask L2 for whole 128-byte lines (two pairs), which the next rows of the
// same box read.  On starts a caller has already sorted by position, the
// sort gains nothing and costs about 2% of the call.

#include <cuda.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kDefaultSmem = 48 << 10;

__device__ __forceinline__ int64_t clamp64(int64_t v, int64_t lo,
                                           int64_t hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Copy n floats from src to dst, this thread taking elements first,
// first + stride, ...  With kVec, n is a multiple of 4 and both pointers
// are 16-byte aligned, and the copy moves float4s.
template <bool kVec>
__device__ __forceinline__ void copy_span(const float* __restrict__ src,
                                          float* __restrict__ dst, int64_t n,
                                          int first, int stride) {
  if (kVec) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    const int64_t n4 = n >> 2;
    int64_t i = first;
    for (; i + 3 * stride < n4; i += 4 * stride) {
      const float4 a = __ldg(s4 + i);
      const float4 b = __ldg(s4 + i + stride);
      const float4 c = __ldg(s4 + i + 2 * stride);
      const float4 d = __ldg(s4 + i + 3 * stride);
      d4[i] = a;
      d4[i + stride] = b;
      d4[i + 2 * stride] = c;
      d4[i + 3 * stride] = d;
    }
    for (; i < n4; i += stride) d4[i] = __ldg(s4 + i);
  } else {
    for (int64_t i = first; i < n; i += stride) dst[i] = __ldg(src + i);
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
window_slices_kernel(const float* __restrict__ feats, int64_t n_rows,
                     int channels, const int32_t* __restrict__ starts,
                     int n_sites, int kmer, float* __restrict__ out) {
  const int site = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (site >= n_sites) return;
  const int64_t s = clamp64(starts[site], 0, n_rows - kmer);
  const int64_t span = (int64_t)kmer * channels;
  copy_span<kVec>(feats + s * channels, out + (int64_t)site * span, span,
                  threadIdx.x & 31, 32);
}

__global__ void __launch_bounds__(kThreads)
window_rows_kernel(const float* __restrict__ d_table,
                   const float* __restrict__ dr_table, int64_t n_rows,
                   int channels, const int32_t* __restrict__ starts,
                   const int32_t* __restrict__ is_rev, int n_sites,
                   int fetch_rows, int out_rows, float* __restrict__ out) {
  const int site = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (site >= n_sites) return;
  const int lane = threadIdx.x & 31;
  const int64_t s = clamp64(starts[site], 0, n_rows - fetch_rows);
  const float* src = (is_rev[site] != 0 ? dr_table : d_table) + s * channels;
  const int n = out_rows * channels;
  float* dst = out + (int64_t)site * n;
  for (int i = lane; i < n; i += 32) {
    const int j = i / channels;
    dst[i] = __ldg(src + (int64_t)(2 * j) * channels + (i - j * channels));
  }
}

// ---- window_rows, TMA route -------------------------------------------------

constexpr int kRowsMaxStages = 8;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

constexpr int kOrderThreads = 256;
constexpr int kOrderPer = 4;                   // sites a thread
constexpr int kOrderChunk = kOrderThreads * kOrderPer;
constexpr int kOrderBuckets = kOrderChunk;

// The order in which the TMA kernel walks the sites.  CTA c sorts chunk c,
// sites [c * kOrderChunk, (c + 1) * kOrderChunk), by (strand, start) into
// kOrderBuckets buckets (a counting sort in shared memory; the order inside
// a bucket is the atomics' and has no effect on the output) and writes
// plan[k] = {site, clamped start << 1 | strand} in that order.  The TMA
// kernel takes the chunks' r-th sites together (rank r of every chunk lies
// at about the same key), so overlapping windows run at about the same
// time and a row pair one site fetched from DRAM is still in L2 for the
// next; in the callers' order (random starts) L2 keeps almost none of them.
// CTA 0 also zeroes the TMA kernel's site counter.
__global__ void __launch_bounds__(kOrderThreads)
site_order_kernel(int64_t n_rows, const int32_t* __restrict__ starts,
                  const int32_t* __restrict__ is_rev, int n_sites,
                  int fetch_rows, uint2* __restrict__ plan,
                  uint32_t* __restrict__ counter) {
  __shared__ uint2 sorted[kOrderChunk];
  __shared__ int cnt[kOrderBuckets];
  __shared__ int warp_sums[kOrderThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int first = blockIdx.x * kOrderChunk;
  const int n = min(kOrderChunk, n_sites - first);
  const int64_t span = n_rows - fetch_rows + 1;      // legal starts per strand
  const double scale = (double)kOrderBuckets / (double)(2 * span);
  if (blockIdx.x == 0 && tid == 0) *counter = 0;

  for (int k = tid; k < kOrderBuckets; k += kOrderThreads) cnt[k] = 0;
  int32_t sv[kOrderPer], rv[kOrderPer];
#pragma unroll
  for (int j = 0; j < kOrderPer; ++j) {
    const int i = j * kOrderThreads + tid;
    if (i < n) {
      sv[j] = __ldg(starts + first + i);
      rv[j] = __ldg(is_rev + first + i);
    }
  }
  __syncthreads();
  int bkt[kOrderPer];
#pragma unroll
  for (int j = 0; j < kOrderPer; ++j) {
    if (j * kOrderThreads + tid < n) {
      const int64_t st = clamp64(sv[j], 0, span - 1);
      const int rev = rv[j] != 0;
      sv[j] = (int32_t)((uint32_t)st << 1 | rev);
      bkt[j] = min((int)((double)(rev * span + st) * scale),
                   kOrderBuckets - 1);
      atomicAdd(&cnt[bkt[j]], 1);
    }
  }
  __syncthreads();

  // exclusive scan of the counts; thread t holds buckets [per t, per t + per)
  constexpr int per = kOrderBuckets / kOrderThreads;
  int own[per], sum = 0;
#pragma unroll
  for (int j = 0; j < per; ++j) sum += (own[j] = cnt[per * tid + j]);
  int incl = sum;
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < kOrderThreads / 32 ? warp_sums[lane] : 0;
    int wi = w;
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, wi, o);
      if (lane >= o) wi += v;
    }
    if (lane < kOrderThreads / 32) warp_sums[lane] = wi - w;
  }
  __syncthreads();
  int run = warp_sums[warp] + incl - sum;
#pragma unroll
  for (int j = 0; j < per; ++j) {
    cnt[per * tid + j] = run;
    run += own[j];
  }
  __syncthreads();

#pragma unroll
  for (int j = 0; j < kOrderPer; ++j) {
    const int i = j * kOrderThreads + tid;
    if (i < n)
      sorted[atomicAdd(&cnt[bkt[j]], 1)] =
          make_uint2((uint32_t)(first + i), (uint32_t)sv[j]);
  }
  __syncthreads();
  for (int i = tid; i < n; i += kOrderThreads) plan[first + i] = sorted[i];
}

// Rows s, s+2, ..., s+2(out_rows-1) of the table the strand selects, for
// every site of the plan.  The sites are taken in the order q = 0, 1, ...:
// rank q / n_chunks of chunk q % n_chunks (ranks past a short last chunk
// are skipped), q handed out by an atomic counter so that the grid stays
// on nearby q.  Thread 0 does all the work: it loads the CTA's k-th site
// into stage k % stages (n_box TMA boxes against the stage's mbarrier),
// and once the stage's barrier flips stores it with one bulk copy.  Loads
// run stages - 1 sites ahead; a stage is loaded again only after its
// store has read it (wait_group.read).
__global__ void __launch_bounds__(32)
window_rows_tma_kernel(const __grid_constant__ CUtensorMap d_map,
                       const __grid_constant__ CUtensorMap dr_map,
                       int channels, const uint2* __restrict__ plan,
                       uint32_t* __restrict__ counter, int n_sites,
                       int out_rows, int n_box, int box_rows, int stages,
                       float* __restrict__ out) {
  if (threadIdx.x != 0) return;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 127) & ~127u;
  const uint32_t box_bytes = (uint32_t)box_rows * channels * 4;
  const uint32_t stage_bytes = n_box * box_bytes;
  const uint32_t bars = ring + stages * stage_bytes;
  const uint32_t store_bytes = (uint32_t)out_rows * channels * 4;
  const uint32_t n_chunks = (n_sites + kOrderChunk - 1) / kOrderChunk;
  const uint32_t n_q = n_chunks * kOrderChunk;

  for (int st = 0; st < stages; ++st)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bars + 8 * st)
                 : "memory");
  // make the initialised barriers visible to the async proxy (the TMA)
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("prefetch.tensormap [%0];" ::"l"(&d_map) : "memory");
  asm volatile("prefetch.tensormap [%0];" ::"l"(&dr_map) : "memory");

  // the plan entry of the next site to load (nxt, valid while have), read
  // one iteration before its load is issued
  bool have = false;
  uint2 nxt;
  auto fetch = [&]() {
    for (;;) {
      const uint32_t q = atomicAdd(counter, 1u);
      if (q >= n_q) {
        have = false;
        return;
      }
      const uint32_t i = (q % n_chunks) * kOrderChunk + q / n_chunks;
      if (i < (uint32_t)n_sites) {
        nxt = __ldg(plan + i);
        have = true;
        return;
      }
    }
  };
  uint32_t site_of[kRowsMaxStages];
  auto issue = [&](int k) {
    const uint32_t s = nxt.y >> 1;
    const uint64_t map = reinterpret_cast<uint64_t>((nxt.y & 1) ? &dr_map
                                                                : &d_map);
    const int col = (int)(s & 1) * channels;
    const int row = (int)(s >> 1);
    const int st = k % stages;
    const uint32_t dst = ring + st * stage_bytes;
    const uint32_t bar = bars + 8 * st;
    site_of[st] = nxt.x;
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
        "r"(stage_bytes)
        : "memory");
    for (int b = 0; b < n_box; ++b)
      asm volatile(
          "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
          "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(
              dst + b * box_bytes),
          "l"(map), "r"(col), "r"(row + b * box_rows), "r"(bar)
          : "memory");
  };

  int loaded = 0;
  for (fetch(); have && loaded < stages; fetch()) issue(loaded++);
  for (int j = 0; j < loaded; ++j) {
    const int st = j % stages;
    mbar_wait(bars + 8 * st, (uint32_t)(j / stages) & 1);
    // the TMA's writes are ordered before this thread by the barrier; order
    // them before the bulk store's reads, which go through the async proxy
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile(
        "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(
            out + (int64_t)site_of[st] * out_rows * channels),
        "r"(ring + st * stage_bytes), "r"(store_bytes)
        : "memory");
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    // refill the stage site j - 1 used (loaded == j - 1 + stages), once
    // its store has read it
    if (j >= 1 && have) {
      asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
      issue(loaded++);
      fetch();
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
group_windows_kernel(const float* __restrict__ feats, int64_t n_rows,
                     int channels, const int32_t* __restrict__ bases,
                     const int32_t* __restrict__ rels, int group,
                     int block_rows, int kmer, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ int s_lo, s_hi;

  const int g = blockIdx.x;
  const int tid = threadIdx.x;
  const int rmax = block_rows - kmer;
  const int32_t* grels = rels + (int64_t)g * group;
  if (tid == 0) {
    s_lo = INT_MAX;
    s_hi = INT_MIN;
  }
  __syncthreads();

  // the group's clamped rel range
  int lo = INT_MAX, hi = INT_MIN;
  for (int t = tid; t < group; t += kThreads) {
    const int r = min(max(grels[t], 0), rmax);
    lo = min(lo, r);
    hi = max(hi, r);
  }
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  if ((tid & 31) == 0 && lo <= hi) {
    atomicMin(&s_lo, lo);
    atomicMax(&s_hi, hi);
  }
  __syncthreads();
  lo = s_lo;

  // stage rows [base + lo, base + hi + kmer) of the table: at most
  // block_rows rows, all inside the table since base <= n_rows - block_rows
  const int64_t base = clamp64(bases[g], 0, n_rows - block_rows);
  const float* src = feats + (base + lo) * channels;
  const int span = (s_hi + kmer - lo) * channels;
  if (kVec) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    for (int i = tid; i < (span >> 2); i += kThreads) smem4[i] = __ldg(s4 + i);
  } else {
    for (int i = tid; i < span; i += kThreads) smem[i] = __ldg(src + i);
  }
  __syncthreads();

  // the group's windows are one contiguous run of group * kmer * C floats
  // in the output; element k is element i of window t, walked with t and i
  // carried along instead of divided out
  const int w = kVec ? (kmer * channels) >> 2 : kmer * channels;
  const int64_t total = (int64_t)group * w;
  int t = 0, i = tid;
  while (i >= w) {
    i -= w;
    ++t;
  }
  int off = 0;
  if (t < group) {
    off = (min(max(__ldg(grels + t), 0), rmax) - lo) * channels;
    if (kVec) off >>= 2;
  }
  for (int64_t k = tid; k < total; k += kThreads) {
    if (kVec) {
      reinterpret_cast<float4*>(out)[(int64_t)g * total + k] = smem4[off + i];
    } else {
      out[(int64_t)g * total + k] = smem[off + i];
    }
    i += kThreads;
    if (i >= w) {
      do {
        i -= w;
        ++t;
      } while (i >= w);
      if (t < group) {
        off = (min(max(__ldg(grels + t), 0), rmax) - lo) * channels;
        if (kVec) off >>= 2;
      }
    }
  }
}

cudaError_t allow_smem(const void* kernel, size_t bytes) {
  if (bytes <= (size_t)kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// cuTensorMapEncodeTiled, reached through the runtime so that this library
// does not link libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

cudaError_t encode_tiled(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess) return e;
    if (q != cudaDriverEntryPointSuccess || p == nullptr)
      return cudaErrorSymbolNotFound;
    cached = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

// Tensor map over `table` (n_rows, C) float32 viewed as (n_rows / 2, 2C)
// row pairs, box {C, box_rows}; out-of-bounds rows read as zeros.
CUresult pair_map(EncodeTiled encode, CUtensorMap* map, const float* table,
                  int64_t n_rows, int channels, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)(2 * channels),
                              (cuuint64_t)(n_rows / 2)};
  const cuuint64_t strides[1] = {(cuuint64_t)(2 * channels) * 4};
  const cuuint32_t box[2] = {(cuuint32_t)channels, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                const_cast<float*>(table), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// The TMA route's launch; its preconditions are checked by the caller.
int launch_window_rows_tma(const float* d_table, const float* dr_table,
                           int64_t n_rows, int channels, const int32_t* starts,
                           const int32_t* is_rev, int n_sites, int fetch_rows,
                           int out_rows, int n_box, int box_rows,
                           int ring_bytes, uint2* plan, float* out,
                           cudaStream_t s) {
  EncodeTiled encode;
  cudaError_t e = encode_tiled(&encode);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap d_map, dr_map;
  CUresult r = pair_map(encode, &d_map, d_table, n_rows, channels, box_rows);
  if (r == CUDA_SUCCESS)
    r = pair_map(encode, &dr_map, dr_table, n_rows, channels, box_rows);
  if (r != CUDA_SUCCESS) return -(int)r;

  const uint32_t stage_bytes = (uint32_t)n_box * box_rows * channels * 4;
  const int stages = (int)std::min((uint32_t)kRowsMaxStages,
                                   (uint32_t)ring_bytes / stage_bytes);
  const size_t smem = 128 + (size_t)stages * stage_bytes + 8 * stages;
  e = allow_smem((const void*)window_rows_tma_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  int dev, sms, per_sm;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, window_rows_tma_kernel, 32, smem)) != cudaSuccess)
    return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int grid = std::min(n_sites, sms * per_sm);
  uint32_t* counter = reinterpret_cast<uint32_t*>(plan + n_sites);
  site_order_kernel<<<(n_sites + kOrderChunk - 1) / kOrderChunk, kOrderThreads,
                      0, s>>>(n_rows, starts, is_rev, n_sites, fetch_rows, plan,
                              counter);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  window_rows_tma_kernel<<<grid, 32, smem, s>>>(d_map, dr_map, channels, plan,
                                                counter, n_sites, out_rows,
                                                n_box, box_rows, stages, out);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points for ctypes.  Each launches on `stream`, does not
// synchronise, allocates nothing, and returns a cudaError_t (0 = launched).

extern "C" int hm_window_slices(const float* feats, int64_t n_rows,
                                int channels, const int32_t* starts,
                                int n_sites, int kmer, float* out,
                                void* stream) {
  if (n_sites <= 0) return (int)cudaSuccess;
  if (channels < 1 || kmer < 1 || n_rows < kmer)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = (n_sites + kWarps - 1) / kWarps;
  if (channels % 4 == 0 && aligned16(feats) && aligned16(out)) {
    window_slices_kernel<true><<<grid, kThreads, 0, s>>>(
        feats, n_rows, channels, starts, n_sites, kmer, out);
  } else {
    window_slices_kernel<false><<<grid, kThreads, 0, s>>>(
        feats, n_rows, channels, starts, n_sites, kmer, out);
  }
  return (int)cudaGetLastError();
}

// `route` 1 is the TMA route with n_box boxes of box_rows rows a site, a
// ring of up to ring_bytes of shared memory a CTA (at least two stages) and
// `plan` scratch of 2 * n_sites + 2 int32 (the site order and its
// counter), 0 the scalar route (n_box, box_rows, ring_bytes and plan
// unused).  A TMA
// route whose preconditions fail returns cudaErrorInvalidValue; a failed
// tensor-map encode returns minus its CUresult.
extern "C" int hm_window_rows(const float* d_table, const float* dr_table,
                              int64_t n_rows, int channels,
                              const int32_t* starts, const int32_t* is_rev,
                              int n_sites, int fetch_rows, int out_rows,
                              int route, int n_box, int box_rows,
                              int ring_bytes, int32_t* plan, float* out,
                              void* stream) {
  if (n_sites <= 0) return (int)cudaSuccess;
  if (channels < 1 || fetch_rows < 2 || (fetch_rows & 1) || out_rows < 1 ||
      out_rows > fetch_rows / 2 || n_rows < fetch_rows)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    if (channels % 4 || channels > 256 || !aligned16(d_table) ||
        !aligned16(dr_table) || !aligned16(out) || box_rows < 1 ||
        box_rows > 256 || (box_rows * channels) % 32 || n_box < 1 ||
        (int64_t)n_box * box_rows < out_rows ||
        2 * (int64_t)n_box * box_rows * channels * 4 > ring_bytes ||
        n_rows / 2 > ((int64_t)1 << 32) || plan == nullptr ||
        (reinterpret_cast<uintptr_t>(plan) & 7))
      return (int)cudaErrorInvalidValue;
    return launch_window_rows_tma(d_table, dr_table, n_rows, channels, starts,
                                  is_rev, n_sites, fetch_rows, out_rows, n_box,
                                  box_rows, ring_bytes,
                                  reinterpret_cast<uint2*>(plan), out, s);
  }
  if (route != 0) return (int)cudaErrorInvalidValue;
  const int grid = (n_sites + kWarps - 1) / kWarps;
  window_rows_kernel<<<grid, kThreads, 0, s>>>(d_table, dr_table, n_rows,
                                               channels, starts, is_rev,
                                               n_sites, fetch_rows, out_rows,
                                               out);
  return (int)cudaGetLastError();
}

extern "C" int hm_group_windows(const float* feats, int64_t n_rows,
                                int channels, const int32_t* bases,
                                const int32_t* rels, int n_groups, int group,
                                int block_rows, int kmer, float* out,
                                void* stream) {
  if (n_groups <= 0) return (int)cudaSuccess;
  if (channels < 1 || group < 1 || kmer < 1 || kmer > block_rows ||
      n_rows < block_rows)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(float) * (size_t)block_rows * channels;
  cudaError_t e;
  if (channels % 4 == 0 && aligned16(feats) && aligned16(out)) {
    e = allow_smem((const void*)group_windows_kernel<true>, smem);
    if (e != cudaSuccess) return (int)e;
    group_windows_kernel<true><<<n_groups, kThreads, smem, s>>>(
        feats, n_rows, channels, bases, rels, group, block_rows, kmer, out);
  } else {
    e = allow_smem((const void*)group_windows_kernel<false>, smem);
    if (e != cudaSuccess) return (int)e;
    group_windows_kernel<false><<<n_groups, kThreads, smem, s>>>(
        feats, n_rows, channels, bases, rels, group, block_rows, kmer, out);
  }
  return (int)cudaGetLastError();
}
