// Exact attention forward (flash schedule) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of atomo_tpu/ops/attention_kernels.py:
//   flash_attention_forward <- flash_attention / _flash_forward (_fa_kernel)
//
// What it computes: for q, k, v of shape (B, H, S, D), float32 or bfloat16,
//   o[b, h, i] = sum_j softmax_j(scale * q[b, h, i] . k[b, h, j]) v[b, h, j]
// over j <= i when causal, with an online-softmax accumulator (m, l, acc) in
// float32 across key tiles, and o written in the input type. Keys past S are
// masked inside the kernel, so any S runs here (the TPU kernel needed S to
// divide by its blocks and otherwise fell back to the blockwise oracle, which
// gives the same numbers). The -inf guards are _fa_kernel's: a row whose every
// key so far is masked keeps m = -inf, contributes p = 0 and alpha = 0, and the
// final division is by max(l, FLT_MIN).
//
// Layout: q, k and v are read through their own (batch, head, row) element
// strides with unit stride along D, so the head views that a transformer
// takes of its fused qkv projection need no copy; o is contiguous (B, H, S, D).
//
// Bound. One launch reads q, k, v and writes o (4 * B*H*S*D elements) and does
// about 4 * B*H*S*S*D operations (2 * S*S*D for q.k^T and as many for p.v; half
// that when causal). At the LM recipe (B 16, H 4, S 1024, D 64, causal) that is
// 67 MB against 8.6 GFLOP: 0.020 ms of memory traffic at 3.35 TB/s against
// 0.128 ms of float32 FMA at 67 TFLOP/s, so it is bound by operations. What
// this first design does about it, simply:
//   * one CTA per (b, h, 64-row query tile); its 256 threads walk the key tiles
//     of 64 rows in a loop (the sequential grid axis of the TPU kernel), so the
//     S x S score matrix never exists and K/V are read once per query tile;
//   * Q, K, V and the probabilities of one tile are staged in shared memory
//     (rows padded by one float so no access pattern conflicts on a bank); each
//     thread keeps a 4 x 4 block of scores and a 4 x D/16 block of the output
//     accumulator in registers, with the running max and sum of its 4 rows;
//   * a row's 64 scores live in 16 lanes of one warp: row max and row sum are
//     warp shuffles, no shared-memory reduction;
//   * causal tiles wholly above the diagonal are not visited at all.
// It uses float32 FMA, not the tensor cores: wgmma with TF32/bf16 operands and
// TMA-fed tiles is the later redesign. The plain PyTorch twin
// (atomo_tpu_torch/ops/attention_kernels.py flash_attention_plain) runs the
// same recurrence with torch ops; the two agree to float32 rounding.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per CTA
constexpr int kBK = 64;        // key rows per tile
constexpr int kThreads = 256;  // 16 x 16 thread grid
constexpr int kRows = 4;       // query rows per thread (kBQ / 16)
constexpr int kCols = 4;       // score columns per thread (kBK / 16)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <int D>
constexpr size_t smem_bytes() {
  // Qs, Ks: (64, D + 1); Vs: (64, D); Ps: (64, 65)
  return sizeof(float) * (2 * kBQ * (D + 1) + kBK * D + kBQ * (kBK + 1));
}

// Load rows [r0, r0 + 64) of one (b, h) slice into a (64, ld) float tile,
// zero past S.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          long long row_stride, int r0, int S) {
  for (int idx = threadIdx.x; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, d = idx - r * D;
    const int row = r0 + r;
    dst[r * ld + d] = row < S ? to_f32(src[(long long)row * row_stride + d]) : 0.0f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_forward_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int H, int S,
                     long long qsb, long long qsh, long long qss,
                     long long ksb, long long ksh, long long kss,
                     long long vsb, long long vsh, long long vss,
                     int causal, float scale) {
  constexpr int kDc = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                      // (kBQ, D + 1)
  float* Ks = Qs + kBQ * (D + 1);        // (kBK, D + 1)
  float* Vs = Ks + kBK * (D + 1);        // (kBK, D)
  float* Ps = Vs + kBK * D;              // (kBQ, kBK + 1)

  // heaviest causal query tiles (the last ones) are issued first
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  const T* qp = q + b * qsb + h * qsh;
  const T* kp = k + b * ksb + h * ksh;
  const T* vp = v + b * vsb + h * vsh;

  load_tile<T, D>(Qs, D + 1, qp, qss, q0, S);

  float m[kRows], l[kRows], acc[kRows][kDc];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < kDc; ++j) acc[i][j] = 0.0f;
  }

  // causal: key tiles starting past this query tile's last row are skipped
  const int k_end = causal ? min(S, q0 + kBQ) : S;
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's Ks/Vs/Ps are consumed
    load_tile<T, D>(Ks, D + 1, kp, kss, k0, S);
    load_tile<T, D>(Vs, D, vp, vss, k0, S);
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = Qs[(ty * kRows + i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = Ks[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qpos = q0 + ty * kRows + i;
      float mc = -INFINITY;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool live = kpos < S && (!causal || kpos <= qpos);
        s[i][j] = live ? s[i][j] * scale : -INFINITY;
        mc = fmaxf(mc, s[i][j]);
      }
      // the row's 64 scores sit in the 16 lanes that share ty
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, off));
      const float m_new = fmaxf(m[i], mc);
      const float m_safe = isfinite(m_new) ? m_new : 0.0f;
      const float alpha = isfinite(m[i]) ? expf(m[i] - m_safe) : 0.0f;
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = isfinite(s[i][j]) ? expf(s[i][j] - m_safe) : 0.0f;
        Ps[(ty * kRows + i) * (kBK + 1) + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      m[i] = m_new;
      l[i] = l[i] * alpha + rs;
#pragma unroll
      for (int j = 0; j < kDc; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();  // Ps is complete

#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[kRows], vv[kDc];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = Ps[(ty * kRows + i) * (kBK + 1) + kk];
#pragma unroll
      for (int j = 0; j < kDc; ++j) vv[j] = Vs[kk * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kDc; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  T* op = o + ((long long)bh * S) * D;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty * kRows + i;
    if (row >= S) continue;
    const float inv = 1.0f / fmaxf(l[i], FLT_MIN);
#pragma unroll
    for (int j = 0; j < kDc; ++j) store(op + (long long)row * D + tx + 16 * j, acc[i][j] * inv);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int S, const long long* st, int causal, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_forward_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (S + kBQ - 1) / kBQ);
  flash_forward_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, H, S, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* o, int B,
               int H, int S, int D, const long long* st, int causal,
               float scale, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, o, B, H, S, st, causal, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, H, S, st, causal, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, H, S, st, causal, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, k, v: (B, H, S, D) with element strides strides[0..2] (q), [3..5] (k),
// [6..8] (v) for batch, head and row, unit stride along D; o contiguous.
// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() of the launch.
int flash_attention_forward(const void* q, const void* k, const void* v,
                            void* o, int B, int H, int S, int D,
                            const long long* strides, int dtype, int causal,
                            float scale, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return dispatch_d<float>(q, k, v, o, B, H, S, D, strides, causal, scale, s);
  if (dtype == 1) return dispatch_d<__nv_bfloat16>(q, k, v, o, B, H, S, D, strides, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
