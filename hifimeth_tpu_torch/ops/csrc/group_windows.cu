// Per-site window gather for the call path, written for Hopper (sm_90a).
//
// Replaces the Pallas kernel group_windows_t of the JAX package
// (hifimeth_tpu/ops/gather.py:303-381) together with what
// call_sites_pallas does right after it (hifimeth_tpu/features/windows.py
// :308-312): keep lanes [0, kmer) and, for the reverse strand, flip the
// lanes and permute the channels.
//
//   forward:  out[g*G + t, c, l] = table[c,       base_g + rel_gt + l]
//   reverse:  out[g*G + t, c, l] = table[perm[c], base_g + rel_gt + kmer-1-l]
//   perm = {3, 2, 1, 0, 6, 7, 4, 5}  (one-hot complement, strand swap of
//                                     the kinetics channels)
//
// table is the (8, n_cols) float32 feature table; out is (n_groups*G, 8,
// kmer) in NCW, float32 or bfloat16 (rounded to nearest even at the write),
// which is what the first convolution takes.
//
// Bound: the kernel is a pure copy, so bytes bound it.  Per group of 32
// sites it writes 32*8*kmer values (410 KB in float32 at kmer 401) and
// needs to read only the 8 rows of the group's span of the table (32
// position-sorted sites ~2.5 bp apart span ~500 lanes, 16 KB).  The output
// writes are ~25x the reads, so the design keeps reads to one pass:
//   - one CTA per group; warp 0 reduces the group's rels to the span
//     [min rel, max rel + kmer) and the CTA stages exactly that span of all
//     8 channels in shared memory with 16-byte loads (scalar, bounds-checked
//     loads where alignment or the table edge do not allow them);
//   - each warp then writes whole output rows (one site, one channel) with
//     consecutive lanes on consecutive l, so stores coalesce and the
//     shared-memory reads (ascending or, for the reverse strand, descending
//     consecutive words) are free of bank conflicts.
// The 2048-lane block, 128-lane alignment and lane rotation of the TPU
// kernel were Mosaic layout rules and are not carried over.
//
// Contract: per group, max(rel) - min(rel) + kmer <= kBlockLanes, and every
// window lies inside the table.  Outside the contract the kernel still
// reads no memory out of bounds (lanes it cannot serve are written as 0).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kChannels = 8;
constexpr int kThreads = 256;
constexpr int kMaxGroup = 32;                    // warp 0 holds the rels
constexpr int kBlockLanes = 2048;                // staged span capacity
constexpr int kSmemLanes = kBlockLanes + 8;      // + 16-byte alignment slack

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename OutT, bool kRev>
__global__ void __launch_bounds__(kThreads)
group_windows_kernel(const float* __restrict__ table, int64_t n_cols,
                     const int32_t* __restrict__ bases,
                     const int32_t* __restrict__ rels, int group, int kmer,
                     OutT* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ int32_t s_rel[kMaxGroup];
  __shared__ int64_t s_lo;
  __shared__ int s_span;

  const int g = blockIdx.x;
  const int tid = threadIdx.x;
  const int64_t base = bases[g];

  if (tid < 32) {
    int lo = INT_MAX, hi = INT_MIN;
    if (tid < group) {
      const int r = rels[(int64_t)g * group + tid];
      s_rel[tid] = r;
      lo = hi = r;
    }
    for (int o = 16; o > 0; o >>= 1) {
      lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
    }
    if (tid == 0) {
      const int64_t first = (base + lo) & ~int64_t(3);   // float4-aligned
      const int64_t span = (base + hi + kmer - first + 3) & ~int64_t(3);
      s_lo = first;
      s_span = (int)(span < kSmemLanes ? span : kSmemLanes);
    }
  }
  __syncthreads();
  const int64_t lo = s_lo;
  const int span = s_span;

  // stage table[:, lo : lo + span) into smem rows of kSmemLanes floats
  const bool vec = ((n_cols & 3) == 0) && lo >= 0 && lo + span <= n_cols &&
                   ((reinterpret_cast<uintptr_t>(table) & 15) == 0);
  if (vec) {
    const int nv = span >> 2;
    for (int i = tid; i < kChannels * nv; i += kThreads) {
      const int c = i / nv, v = i - c * nv;
      const float4* src =
          reinterpret_cast<const float4*>(table + c * n_cols + lo) + v;
      smem4[c * (kSmemLanes / 4) + v] = __ldg(src);
    }
  } else {
    for (int i = tid; i < kChannels * span; i += kThreads) {
      const int c = i / span, j = i - c * span;
      const int64_t p = lo + j;
      smem[c * kSmemLanes + j] =
          (p >= 0 && p < n_cols) ? __ldg(table + c * n_cols + p) : 0.f;
    }
  }
  __syncthreads();

  // one warp per output row (site t, channel c)
  const int warp = tid >> 5, lane = tid & 31;
  for (int r = warp; r < group * kChannels; r += kThreads / 32) {
    const int t = r >> 3, c = r & 7;
    const int sc = kRev ? (c < 4 ? 3 - c : c ^ 2) : c;
    const int64_t off = base + s_rel[t] - lo;      // window start in smem
    const float* row = smem + sc * kSmemLanes;
    OutT* dst = out + ((int64_t)g * group + t) * (kChannels * kmer) +
                (int64_t)c * kmer;
    for (int l = lane; l < kmer; l += 32) {
      const int64_t j = off + (kRev ? kmer - 1 - l : l);
      store(dst + l, (j >= 0 && j < span) ? row[j] : 0.f);
    }
  }
}

template <typename OutT, bool kRev>
cudaError_t launch(const float* table, int64_t n_cols, const int32_t* bases,
                   const int32_t* rels, int n_groups, int group, int kmer,
                   void* out, cudaStream_t stream) {
  const size_t smem = sizeof(float) * kChannels * kSmemLanes;
  auto kernel = group_windows_kernel<OutT, kRev>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<n_groups, kThreads, smem, stream>>>(
      table, n_cols, bases, rels, group, kmer, static_cast<OutT*>(out));
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes.  Launches on `stream`, does not
// synchronise, allocates nothing; returns a cudaError_t (0 = launched).
extern "C" int hm_group_windows_t(const float* table, int64_t n_cols,
                                  const int32_t* bases, const int32_t* rels,
                                  int n_groups, int group, int kmer, int rev,
                                  int out_bf16, void* out, void* stream) {
  if (n_groups <= 0) return (int)cudaSuccess;
  if (group < 1 || group > kMaxGroup || kmer < 1 || kmer > kBlockLanes)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (out_bf16) {
    e = rev ? launch<__nv_bfloat16, true>(table, n_cols, bases, rels,
                                          n_groups, group, kmer, out, s)
            : launch<__nv_bfloat16, false>(table, n_cols, bases, rels,
                                           n_groups, group, kmer, out, s);
  } else {
    e = rev ? launch<float, true>(table, n_cols, bases, rels, n_groups, group,
                                  kmer, out, s)
            : launch<float, false>(table, n_cols, bases, rels, n_groups,
                                   group, kmer, out, s);
  }
  return (int)e;
}
