// Coarse-stage scoring for Hopper (sm_90a): per-stride-segment max of the
// frame <-> query similarity, without materializing the (Q, L) score matrix.
//
//   out[b, q, s] = max_{f in [s*stride, (s+1)*stride), f < min(ctx_l[b], L)}
//                    sum_d feats[b, f, d] * cls[b, q, d]
//   and -1e30 for a segment with no valid frame.
//
// Replaces the TPU kernel cone_tpu/ops/pallas_coarse.py:66
// coarse_segment_max (body _kernel, :31-62).
//
// Bound on the card: the feature stream. Every frame row is read once
// (MAD: 36864 x 512 fp32 = 75.5 MB) against 2*Q*D flops per frame, about
// 16 flops per byte at Q = 32, far below the fp32 ridge of the card, so
// the kernel is bound by memory bytes. The design keeps the feature rows
// the only device-memory stream: one block per (segment, video) stages the
// query matrix in shared memory once, then walks its segment in tiles of 8
// frames that all 256 threads load with coalesced 16-byte reads. Each warp
// takes one frame of the tile and each lane one query, accumulating the dot
// product in fp32 with FMA; a running max per lane and a final max across
// warps give the segment's value. Padding the staged query rows to D + 4
// floats keeps the lanes' 16-byte shared-memory reads free of bank
// conflicts. The ragged tail (frames at or past ctx_l, or past L) is masked
// here: the caller never pads the feature stream.
//
// C interface, loaded with ctypes. The launch goes on the caller's stream,
// allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kFrameTile = kWarps;   // frames staged per step: one per warp
constexpr int kMaxQGroups = 4;       // Q <= 128: lanes hold one query per group
constexpr float kNegInf = -1e30f;

__host__ __device__ inline size_t smem_floats(int Q, int D) {
  return (size_t)Q * (D + 4) + (size_t)kFrameTile * D + (size_t)kWarps * Q;
}

__global__ void __launch_bounds__(kThreads)
coarse_segment_max_kernel(const float* __restrict__ feats,
                          const float* __restrict__ cls,
                          const int* __restrict__ ctx_l,
                          float* __restrict__ out,
                          int L, int D, int Q, int stride, int n_seg) {
  extern __shared__ __align__(16) float smem[];
  const int cls_ld = D + 4;
  float* cls_s = smem;                        // (Q, D + 4)
  float* feat_s = cls_s + (size_t)Q * cls_ld;  // (kFrameTile, D)
  float* red_s = feat_s + kFrameTile * D;      // (kWarps, Q)

  const int s = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int d4 = D >> 2;
  const float* feats_b = feats + (size_t)b * L * D;
  const float* cls_b = cls + (size_t)b * Q * D;

  for (int i = tid; i < Q * d4; i += kThreads) {
    const int q = i / d4;
    const int c = i - q * d4;
    const float4 v = reinterpret_cast<const float4*>(cls_b + (size_t)q * D)[c];
    *reinterpret_cast<float4*>(cls_s + q * cls_ld + 4 * c) = v;
  }

  const int lo = s * stride;
  const int hi = min(lo + stride, min(L, ctx_l[b]));  // exclusive
  const int n_groups = (Q + 31) >> 5;
  float best[kMaxQGroups];
#pragma unroll
  for (int g = 0; g < kMaxQGroups; ++g) best[g] = kNegInf;

  for (int t0 = lo; t0 < hi; t0 += kFrameTile) {
    const int nf = min(kFrameTile, hi - t0);
    __syncthreads();  // query rows staged / previous tile consumed
    const float4* src = reinterpret_cast<const float4*>(feats_b + (size_t)t0 * D);
    float4* dst = reinterpret_cast<float4*>(feat_s);
    for (int i = tid; i < nf * d4; i += kThreads) dst[i] = src[i];
    __syncthreads();
    if (warp < nf) {
      const float4* f4 = reinterpret_cast<const float4*>(feat_s + warp * D);
#pragma unroll
      for (int g = 0; g < kMaxQGroups; ++g) {
        const int q = g * 32 + lane;
        if (g < n_groups && q < Q) {
          const float4* c4 = reinterpret_cast<const float4*>(cls_s + q * cls_ld);
          float acc = 0.f;
          for (int c = 0; c < d4; ++c) {
            const float4 f = f4[c];
            const float4 w = c4[c];
            acc = fmaf(f.x, w.x, acc);
            acc = fmaf(f.y, w.y, acc);
            acc = fmaf(f.z, w.z, acc);
            acc = fmaf(f.w, w.w, acc);
          }
          best[g] = fmaxf(best[g], acc);
        }
      }
    }
  }

#pragma unroll
  for (int g = 0; g < kMaxQGroups; ++g) {
    const int q = g * 32 + lane;
    if (g < n_groups && q < Q) red_s[warp * Q + q] = best[g];
  }
  __syncthreads();
  for (int q = tid; q < Q; q += kThreads) {
    float m = red_s[q];
    for (int w = 1; w < kWarps; ++w) m = fmaxf(m, red_s[w * Q + q]);
    out[((size_t)b * Q + q) * n_seg + s] = m;
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory the launch needs, in bytes.
size_t coarse_segment_max_smem_bytes(int Q, int D) {
  return smem_floats(Q, D) * sizeof(float);
}

const char* coarse_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// feats (B, L, D) fp32, cls (B, Q, D) fp32, ctx_l (B,) int32, out
// (B, Q, n_seg) fp32 with n_seg = ceil(L / stride); all contiguous, device
// pointers 16-byte aligned, D % 4 == 0, 1 <= Q <= 128.
int coarse_segment_max_f32(const float* feats, const float* cls,
                           const int* ctx_l, float* out, int B, int L, int D,
                           int Q, int stride, int n_seg, void* stream) {
  if (B < 1 || L < 1 || D < 4 || (D & 3) || Q < 1 || Q > 32 * kMaxQGroups ||
      stride < 1 || n_seg != (L + stride - 1) / stride || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = coarse_segment_max_smem_bytes(Q, D);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        coarse_segment_max_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(n_seg, B);
  coarse_segment_max_kernel<<<grid, kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      feats, cls, ctx_l, out, L, D, Q, stride, n_seg);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
