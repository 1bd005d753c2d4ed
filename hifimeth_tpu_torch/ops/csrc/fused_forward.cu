// Window gather + the whole DNAModNet forward in one kernel, written for
// Hopper (sm_90a).
//
// Replaces the Pallas kernel _fused_kernel of the JAX package
// (hifimeth_tpu/ops/fused.py:192, launched by fused_forward at :373).  For
// every planned site it computes, without writing any activation to device
// memory, the reference DNAModNet forward of that site's window:
//
//   window[c, l] = table[c,       start + l]             (forward)
//   window[c, l] = table[perm[c], start + kmer - 1 - l]  (reverse strand)
//   perm = {3, 2, 1, 0, 6, 7, 4, 5}
//   x0 = window * bn0_scale[c] + bn0_shift[c]   (window channel c)
//   x1 = relu(conv1(x0)), K = 11 (CpG/CHG) or 13 (CHH), stride 2, zero pad
//        (1, 1) at the window's edges, after bn0
//   x2..x8 = relu(conv(x)), K = 3, stride 2, zero pad (1, 1)
//   logits = fc2(relu(fc1(flatten(x8)))), flatten channel-major (c * L + l)
//
// and writes only the 2 logits per site.  Per-window semantics hold exactly:
// bn0 is applied while the window is staged, and only the convolution's own
// pad taps are zero.  None of the TPU kernel's block tricks (stride-1 block
// conv1 with lane rotations, bn0 folded into conv1 with edge corrections,
// 128-channel padding, a pre-reversed table) is carried over.
//
// Bound: operations.  Per window the convolutions and FC layers of the
// shipped models take 22,297,600 FLOP (CpG/CHG) or 22,881,280 (CHH); the
// bytes (the table span the windows cover, the weights, 8 B of logits per
// site) are three orders of magnitude below the FP32 rate's worth.  This
// first design does nothing about the bound beyond running every product as
// plain FP32 FFMA on the CUDA cores with register tiles:
//   - one CTA of 512 threads per site; the site's activations ping-pong
//     between two shared-memory buffers (the largest, conv1's 128 x 197
//     output, is ~100 KB), so one CTA runs per SM;
//   - each activation row is stored as its zero-padded sequence split into
//     even and odd lanes, so a stride-2 tap reads consecutive words;
//   - each warp owns 8 output channels; its lanes split into PL position
//     lanes (each up to TN output positions, PL * TN >= the layer's length)
//     times 32 / PL input-channel slices, whose partial sums a shuffle
//     reduction adds at the end.  Deep layers are short (conv8 has 2
//     positions), so without the channel split most lanes would idle and
//     each warp would walk all input channels in one serial chain of
//     weight loads; each layer's channel stride is chosen so the slices'
//     shared-memory reads fall in distinct banks;
//   - weights are read as two float4 per (input channel, tap) through the
//     read-only cache (a layer's weights stay in L1/L2: conv2's are 196 KB).
// Sharing conv1 across a group's overlapping windows, wgmma on the tensor
// cores and TMA staging are left for later work.
//
// Contract: the geometry in `meta` (checked in hm_fused_forward) and windows
// inside the table; lanes outside the table read as 0.
//
// Stage ablation (scripts/profile_fused_layers.py): built with
// -DHM_FUSED_STAGES=n, the kernel stops after stage n (0 = the staged
// window, 1..8 = conv1..conv8) and writes zero logits.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kChannels = 8;
constexpr int kLayers = 8;
constexpr int kThreads = 512;
constexpr int kCoPerWarp = 8;
constexpr int kMaxCout = (kThreads / 32) * kCoPerWarp;     // 128
constexpr int kMaxGroup = 32;
constexpr int kMaxOut = kThreads / 32;
constexpr size_t kMaxSmem = 232448;                        // sm_90 per block
// Per layer: position lanes per warp (the other 32 / kPl lanes split the
// input channels) and positions per lane; Lout <= kPl[l] * kTn[l].
constexpr int kPl[kLayers] = {32, 16, 8, 4, 2, 1, 1, 1};
constexpr int kTn[kLayers] = {7, 7, 7, 7, 7, 7, 4, 2};

struct Layer {
  int k, cin, cout, lin, lout, w_off, b_off;
  int in_stride, out_stride;   // floats per channel row of input / output
};

// Field order of `meta` (ops/fused.py _meta): the net's scalars, then seven
// ints per convolution.
struct Net {
  int kmer;
  int bn_scale_off, bn_shift_off;
  int fc1_w_off, fc1_b_off, fc1_in, fc1_out;
  int fc2_w_off, fc2_b_off, n_out;
  Layer conv[kLayers];
  int buf_a, buf_b;   // floats of the two shared-memory activation buffers
};
constexpr int kMetaLen = 10 + 7 * kLayers;

#ifndef HM_FUSED_STAGES
#define HM_FUSED_STAGES (kLayers + 1)
#endif
#define HM_STOP_AFTER(stage)                                             \
  if (HM_FUSED_STAGES <= (stage)) {                                       \
    if (threadIdx.x < net.n_out) out[site * net.n_out + threadIdx.x] = 0.f; \
    return;                                                                \
  }

// Length of each even/odd plane of an activation of `len` lanes stored with
// its zero pads (len + 2 lanes).
__host__ __device__ constexpr int half_len(int len) { return (len + 3) / 2; }

// Channel row stride of an activation of `len` lanes read by a layer with
// `pl` position lanes: at least both planes, and == pl (mod 32) when the
// warp splits its input channels, so the 32 / pl slices, reading rows
// ci, ci + 1, ... at the same positions, hit distinct banks.
constexpr int row_stride(int len, int pl) {
  const int n = 2 * half_len(len);
  return pl == 32 ? n : n + ((pl - n) % 32 + 32) % 32;
}

// One stride-2, pad-(1, 1) convolution + bias + ReLU over shared memory.
// in/out: per channel the even plane then the odd plane of the padded row.
template <int K, int TN, int PL>
__device__ __forceinline__ void conv_layer(const float* __restrict__ in,
                                           float* __restrict__ out,
                                           const Layer L,
                                           const float* __restrict__ wts) {
  constexpr int kSlices = 32 / PL;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pl = lane % PL, slice = lane / PL;
  const int co0 = warp * kCoPerWarp;
  if (co0 >= L.cout) return;
  const int hin = half_len(L.lin), hout = half_len(L.lout);
  const float* __restrict__ w = wts + L.w_off + co0;   // (K, cin, cout)
  int pos[TN];
#pragma unroll
  for (int t = 0; t < TN; ++t) pos[t] = min(pl + PL * t, L.lout - 1);
  float acc[kCoPerWarp][TN];
#pragma unroll
  for (int j = 0; j < kCoPerWarp; ++j) {
    const float b = slice == 0 ? __ldg(wts + L.b_off + co0 + j) : 0.f;
#pragma unroll
    for (int t = 0; t < TN; ++t) acc[j][t] = b;
  }
  const int tap_stride = L.cin * L.cout;
#pragma unroll 2
  for (int ci = slice; ci < L.cin; ci += kSlices) {
    const float* xe = in + ci * L.in_stride;   // padded lanes 0, 2, 4, ...
    const float* xo = xe + hin;                // padded lanes 1, 3, 5, ...
#pragma unroll
    for (int k = 0; k < K; ++k) {
      // output p reads padded lane 2p + k
      const float4* wp = reinterpret_cast<const float4*>(
          w + k * tap_stride + ci * L.cout);
      const float4 wa = __ldg(wp), wb = __ldg(wp + 1);
      const float wv[kCoPerWarp] = {wa.x, wa.y, wa.z, wa.w,
                                    wb.x, wb.y, wb.z, wb.w};
      const float* src = ((k & 1) ? xo : xe) + (k >> 1);
#pragma unroll
      for (int t = 0; t < TN; ++t) {
        const float x = src[pos[t]];
#pragma unroll
        for (int j = 0; j < kCoPerWarp; ++j)
          acc[j][t] = fmaf(wv[j], x, acc[j][t]);
      }
    }
  }
  // add the slices' partial sums (lanes pl, pl + PL, pl + 2 PL, ...)
#pragma unroll
  for (int o = PL; o < 32; o <<= 1)
#pragma unroll
    for (int j = 0; j < kCoPerWarp; ++j)
#pragma unroll
      for (int t = 0; t < TN; ++t)
        acc[j][t] += __shfl_xor_sync(0xffffffffu, acc[j][t], o);
  if (slice) return;
  // output p goes to padded lane p + 1; lanes 0 and lout + 1 are the pads
  float* dst = out + co0 * L.out_stride;
#pragma unroll
  for (int t = 0; t < TN; ++t) {
    const int p = pl + PL * t;
    if (p < L.lout) {
      const int q = p + 1, r = L.lout + 1;
#pragma unroll
      for (int j = 0; j < kCoPerWarp; ++j) {
        float* row = dst + j * L.out_stride;
        row[(q & 1) * hout + (q >> 1)] = fmaxf(acc[j][t], 0.f);
        if (p == 0) row[0] = 0.f;
        if (p == L.lout - 1) row[(r & 1) * hout + (r >> 1)] = 0.f;
      }
    }
  }
}

template <int K1>
__global__ void __launch_bounds__(kThreads, 1)
fused_forward_kernel(const float* __restrict__ table, int64_t n_cols,
                     const int32_t* __restrict__ bases,
                     const int32_t* __restrict__ rels, int group, int rev,
                     const float* __restrict__ wts, const Net net,
                     float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* buf_a = reinterpret_cast<float*>(smem4);
  float* buf_b = buf_a + net.buf_a;

  const int64_t site = blockIdx.x;
  const int64_t start = (int64_t)bases[site / group] + rels[site];

  // stage the window with bn0 applied into buf_b (padded, even/odd planes)
  const int kmer = net.kmer, h0 = half_len(kmer);
  const int s0 = net.conv[0].in_stride;
  for (int i = threadIdx.x; i < kChannels * kmer; i += kThreads) {
    const int c = i / kmer, l = i - c * kmer;
    const int tc = rev ? (c < 4 ? 3 - c : c ^ 2) : c;
    const int64_t lane = start + (rev ? kmer - 1 - l : l);
    const float v = (lane >= 0 && lane < n_cols)
                        ? __ldg(table + tc * n_cols + lane) : 0.f;
    const int q = l + 1;
    buf_b[c * s0 + (q & 1) * h0 + (q >> 1)] =
        fmaf(v, __ldg(wts + net.bn_scale_off + c),
             __ldg(wts + net.bn_shift_off + c));
  }
  if (threadIdx.x < kChannels) {
    float* row = buf_b + threadIdx.x * s0;
    const int r = kmer + 1;
    row[0] = 0.f;
    row[(r & 1) * h0 + (r >> 1)] = 0.f;
  }
  __syncthreads();
  HM_STOP_AFTER(0)

  conv_layer<K1, kTn[0], kPl[0]>(buf_b, buf_a, net.conv[0], wts);
  __syncthreads();
  HM_STOP_AFTER(1)
  conv_layer<3, kTn[1], kPl[1]>(buf_a, buf_b, net.conv[1], wts);
  __syncthreads();
  HM_STOP_AFTER(2)
  conv_layer<3, kTn[2], kPl[2]>(buf_b, buf_a, net.conv[2], wts);
  __syncthreads();
  HM_STOP_AFTER(3)
  conv_layer<3, kTn[3], kPl[3]>(buf_a, buf_b, net.conv[3], wts);
  __syncthreads();
  HM_STOP_AFTER(4)
  conv_layer<3, kTn[4], kPl[4]>(buf_b, buf_a, net.conv[4], wts);
  __syncthreads();
  HM_STOP_AFTER(5)
  conv_layer<3, kTn[5], kPl[5]>(buf_a, buf_b, net.conv[5], wts);
  __syncthreads();
  HM_STOP_AFTER(6)
  conv_layer<3, kTn[6], kPl[6]>(buf_b, buf_a, net.conv[6], wts);
  __syncthreads();
  HM_STOP_AFTER(7)
  conv_layer<3, kTn[7], kPl[7]>(buf_a, buf_b, net.conv[7], wts);
  __syncthreads();
  HM_STOP_AFTER(8)

  // fc1 over the flattened conv8 output (buf_b): the threads split each
  // output's inputs into kThreads / fc1_out slices; partial sums go to
  // buf_a[slice * fc1_out + o], then one thread per output adds them, the
  // bias and the ReLU into buf_a[o]
  const Layer L8 = net.conv[kLayers - 1];
  const int h8 = half_len(L8.lout);
  const int fc_slices = kThreads / net.fc1_out;
  const int per_slice = (net.fc1_in + fc_slices - 1) / fc_slices;
  if (threadIdx.x < fc_slices * net.fc1_out) {
    const int o = threadIdx.x % net.fc1_out, sl = threadIdx.x / net.fc1_out;
    const int i1 = min(net.fc1_in, (sl + 1) * per_slice);
    float acc = 0.f;
    for (int i = sl * per_slice; i < i1; ++i) {
      const int c = i / L8.lout, q = i - c * L8.lout + 1;
      acc = fmaf(__ldg(wts + net.fc1_w_off + i * net.fc1_out + o),
                 buf_b[c * L8.out_stride + (q & 1) * h8 + (q >> 1)], acc);
    }
    buf_a[sl * net.fc1_out + o] = acc;
  }
  __syncthreads();
  float hidden = 0.f;
  if (threadIdx.x < net.fc1_out) {
    hidden = __ldg(wts + net.fc1_b_off + threadIdx.x);
    for (int sl = 0; sl < fc_slices; ++sl)
      hidden += buf_a[sl * net.fc1_out + threadIdx.x];
  }
  __syncthreads();
  if (threadIdx.x < net.fc1_out) buf_a[threadIdx.x] = fmaxf(hidden, 0.f);
  __syncthreads();

  // fc2: one warp per logit
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp < net.n_out) {
    float acc = 0.f;
    for (int i = lane; i < net.fc1_out; i += 32)
      acc = fmaf(__ldg(wts + net.fc2_w_off + i * net.n_out + warp), buf_a[i],
                 acc);
    for (int o = 16; o > 0; o >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0)
      out[site * net.n_out + warp] = acc + __ldg(wts + net.fc2_b_off + warp);
  }
}

// Parse and check `meta`; fills `net` (with its buffer sizes) or returns
// false.
bool parse_net(const int32_t* meta, int n_meta, Net* net) {
  if (n_meta != kMetaLen) return false;
  const int32_t* m = meta;
  net->kmer = *m++;
  net->bn_scale_off = *m++;
  net->bn_shift_off = *m++;
  net->fc1_w_off = *m++;
  net->fc1_b_off = *m++;
  net->fc1_in = *m++;
  net->fc1_out = *m++;
  net->fc2_w_off = *m++;
  net->fc2_b_off = *m++;
  net->n_out = *m++;
  int in_stride = row_stride(net->kmer, kPl[0]);
  int buf_a = 0, buf_b = kChannels * in_stride;
  int cin = kChannels, lin = net->kmer;
  for (int l = 0; l < kLayers; ++l) {
    Layer& L = net->conv[l];
    L.k = *m++;
    L.cin = *m++;
    L.cout = *m++;
    L.lin = *m++;
    L.lout = *m++;
    L.w_off = *m++;
    L.b_off = *m++;
    const bool k_ok = l == 0 ? (L.k == 11 || L.k == 13) : L.k == 3;
    if (!k_ok || L.cin != cin || L.lin != lin || L.cout < kCoPerWarp ||
        L.cout > kMaxCout || L.cout % kCoPerWarp ||
        L.lout != (L.lin + 2 - L.k) / 2 + 1 || L.lout < 1 ||
        L.lout > kPl[l] * kTn[l] || L.w_off % 4 || L.w_off < 0 ||
        L.b_off < 0)
      return false;
    L.in_stride = in_stride;
    L.out_stride = row_stride(L.lout, l + 1 < kLayers ? kPl[l + 1] : 32);
    in_stride = L.out_stride;
    const int need = L.cout * L.out_stride;
    int& buf = (l % 2 == 0) ? buf_a : buf_b;
    buf = need > buf ? need : buf;
    cin = L.cout;
    lin = L.lout;
  }
  if (net->fc1_in != cin * lin || net->fc1_out < 1 ||
      net->fc1_out > kThreads || net->n_out < 1 || net->n_out > kMaxOut)
    return false;
  // fc1's partial sums: one row of fc1_out per slice of the threads
  const int fc_need = (kThreads / net->fc1_out) * net->fc1_out;
  buf_a = fc_need > buf_a ? fc_need : buf_a;
  net->buf_a = (buf_a + 3) & ~3;               // keep buf_b 16-byte aligned
  net->buf_b = buf_b;
  return true;
}

template <int K1>
cudaError_t launch(const float* table, int64_t n_cols, const int32_t* bases,
                   const int32_t* rels, int n_groups, int group, int rev,
                   const float* weights, const Net& net, float* out,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)(net.buf_a + net.buf_b);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = fused_forward_kernel<K1>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<n_groups * group, kThreads, smem, stream>>>(
      table, n_cols, bases, rels, group, rev, weights, net, out);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes.  table (8, n_cols) f32; bases (n_groups,)
// and rels (n_groups, group) int32; weights and meta as packed by
// ops/fused.py; out (n_groups * group, n_out) f32.  Launches on `stream`,
// does not synchronise, allocates nothing; returns a cudaError_t (0 =
// launched).
extern "C" int hm_fused_forward(const float* table, int64_t n_cols,
                                const int32_t* bases, const int32_t* rels,
                                int n_groups, int group, int rev,
                                const float* weights, const int32_t* meta,
                                int n_meta, float* out, void* stream) {
  if (n_groups <= 0) return (int)cudaSuccess;
  Net net;
  if (group < 1 || group > kMaxGroup || !parse_net(meta, n_meta, &net))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = net.conv[0].k == 11
      ? launch<11>(table, n_cols, bases, rels, n_groups, group, rev, weights,
                   net, out, s)
      : launch<13>(table, n_cols, bases, rels, n_groups, group, rev, weights,
                   net, out, s);
  return (int)e;
}
