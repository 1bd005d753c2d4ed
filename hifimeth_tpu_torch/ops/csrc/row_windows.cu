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
// 8 float32 are 32 B, so every copy moves 16-byte vectors with consecutive
// lanes on consecutive addresses (scalar copies where C % 4 != 0 or a
// pointer is not 16-byte aligned):
//   - window_slices: one warp per site streams its window, one contiguous
//     span of kmer*C floats in and out, with four loads in flight per lane
//     before their stores;
//   - window_rows: one warp per site reads rows s, s+2, ... of the table
//     is_rev selects and writes them densely;
//   - group_windows: one CTA per group reduces the group's clamped rels to
//     the span [min r, max r + kmer) of its block, stages exactly that span
//     once in shared memory (at most block_rows rows), then writes the
//     group's windows, which are contiguous in the output, from shared
//     memory with coalesced stores.
// The Pallas grids (spp sites per step, one block DMA per group with double
// buffering) were the TPU's way to keep DMAs in flight and are not carried
// over: here many warps in flight on every SM do that.

#include <cuda_runtime.h>

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

template <bool kVec>
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
  if (kVec) {
    // float4 i of the window: output row j = i / q, part p = i % q, read
    // from table row s + 2j
    const int q = channels >> 2;
    const int n4 = out_rows * q;
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(out) + (int64_t)site * n4;
    for (int i = lane; i < n4; i += 32) {
      const int j = i / q;
      d4[i] = __ldg(s4 + (int64_t)(2 * j) * q + (i - j * q));
    }
  } else {
    const int n = out_rows * channels;
    float* dst = out + (int64_t)site * n;
    for (int i = lane; i < n; i += 32) {
      const int j = i / channels;
      dst[i] = __ldg(src + (int64_t)(2 * j) * channels + (i - j * channels));
    }
  }
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

extern "C" int hm_window_rows(const float* d_table, const float* dr_table,
                              int64_t n_rows, int channels,
                              const int32_t* starts, const int32_t* is_rev,
                              int n_sites, int fetch_rows, int out_rows,
                              float* out, void* stream) {
  if (n_sites <= 0) return (int)cudaSuccess;
  if (channels < 1 || fetch_rows < 2 || (fetch_rows & 1) || out_rows < 1 ||
      out_rows > fetch_rows / 2 || n_rows < fetch_rows)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = (n_sites + kWarps - 1) / kWarps;
  if (channels % 4 == 0 && aligned16(d_table) && aligned16(dr_table) &&
      aligned16(out)) {
    window_rows_kernel<true><<<grid, kThreads, 0, s>>>(
        d_table, dr_table, n_rows, channels, starts, is_rev, n_sites,
        fetch_rows, out_rows, out);
  } else {
    window_rows_kernel<false><<<grid, kThreads, 0, s>>>(
        d_table, dr_table, n_rows, channels, starts, is_rev, n_sites,
        fetch_rows, out_rows, out);
  }
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
