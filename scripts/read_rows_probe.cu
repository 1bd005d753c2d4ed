// DRAM-granularity probe for scripts/probe_window_rows.py; not a kernel of
// the port.  Reads n_read rows of 32 bytes, rows 0, step, 2 step, ... of a
// table, two 16-byte loads a row, four rows in flight a thread, and writes
// one sum per warp so the reads are kept.  Timing step 1 against step 2
// shows whether reading every other 32-byte row costs the DRAM half or all
// of the bytes: 32-byte sectors or 64-byte bursts.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
read_rows_probe(const float4* __restrict__ table, int64_t n_read, int step,
                float* __restrict__ out) {
  const int64_t n_vec = 2 * n_read;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  auto at = [&](int64_t i) {
    const float4 v = __ldg(table + (i >> 1) * 2 * step + (i & 1));
    return (v.x + v.y) + (v.z + v.w);
  };
  float acc = 0.f;
  int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  for (; i + 3 * stride < n_vec; i += 4 * stride)
    acc += (at(i) + at(i + stride)) + (at(i + 2 * stride) + at(i + 3 * stride));
  for (; i < n_vec; i += stride) acc += at(i);
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if ((threadIdx.x & 31) == 0)
    out[((int64_t)blockIdx.x * kThreads + threadIdx.x) >> 5] = acc;
}

}  // namespace

// Reads n_read 32-byte rows, `step` rows apart, of a 16-byte aligned table
// of at least (n_read - 1) * step + 1 rows; `out` holds one float per warp
// of `blocks` CTAs of 256 threads.  Launches on `stream`; returns a
// cudaError_t (0 = launched).
extern "C" int hm_read_rows_probe(const float* table, int64_t n_read, int step,
                                  int blocks, float* out, void* stream) {
  if (n_read < 1 || step < 1 || blocks < 1 ||
      (reinterpret_cast<uintptr_t>(table) & 15))
    return (int)cudaErrorInvalidValue;
  read_rows_probe<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(table), n_read, step, out);
  return (int)cudaGetLastError();
}
