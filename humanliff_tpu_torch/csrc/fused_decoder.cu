// Fused NeRF decoder MLP for Hopper (sm_90a): one kernel per decoder call.
//
// Replaces humanliff_tpu/ops/pallas/decoder.py::fused_decoder, the Pallas TPU
// kernel launched by pl.pallas_call at ops/pallas/decoder.py:80 (body `_kernel`,
// :46-69). Per sample point it computes what nerf/decoder.py::NeRFDecoder does:
//   trunk  h = softplus(x W0 + b0); h = softplus(h W1 + b1);
//          h = softplus([x, h] W2 + b2)                       (27 -> 128 -> 128 -> 128)
//   heads  alpha = h Wa + ba;  feat = h Wf + bf               (128 -> 1, 128 -> 128)
//   view   rgb = softplus([feat, PE4(d)] Wv + bv) Wr + br     (155 -> 64 -> 3)
// PE4(d) = [d, sin d, cos d, sin 2d, cos 2d, sin 4d, cos 4d, sin 8d, cos 8d].
// The density-only variant (FULL = false) stops after alpha: the renderer's
// coarse pass needs no colour.
//
// What bounds it on an H100: operations. A point reads 30 inputs and writes 4
// outputs (136 bytes in fp32) but costs 2 x 66,304 flops, about 975 flops per
// byte, far above the card's ~300 flops/byte balance point for bf16 tensor
// cores and ~20 for fp32 SIMT. The TPU kernel kept all 66,884 weights in VMEM;
// here they are 261 KB in fp32, more than the 227 KB of shared memory a block
// may hold, and a point's 155-wide activation does not fit in one thread's
// registers. So:
//   - a block of 256 threads owns a tile of 64 points; the tile's activations
//     live in two shared-memory buffers (A: 64 x 155, B: 64 x 128) and never
//     touch device memory;
//   - each layer is a small tiled GEMM: the block stages 32 rows of the
//     layer's weight matrix at a time into shared memory (the weights stay in
//     L2, read once per block per layer) and each thread accumulates a 4-point
//     x 8-neuron register tile in fp32;
//   - inputs may be fp32 or bf16 (the renderer keeps planes in bf16); all
//     arithmetic is fp32, as the JAX decoder promotes bf16 features against
//     fp32 parameters. PE4 of bf16 directions is rounded to bf16, as JAX
//     evaluates it in the directions' dtype.
// This is plain SIMT fp32 FMA work: a tensor-core (wgmma) version is the next
// step. The edge tile is masked here (no padding of M by the caller). The
// launcher runs on the caller's stream, allocates nothing, and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int D_IN = 27;
constexpr int D_H = 128;
constexpr int D_CAT = 155;  // 27 + 128 (trunk skip) and 128 + 27 (view input)
constexpr int D_VIEW = 64;

constexpr int TILE_P = 64;          // points per block
constexpr int THREADS = 256;        // 16 neuron groups x 16 point groups
constexpr int PPT = TILE_P / 16;    // points per thread
constexpr int KC = 32;              // weight rows staged per step
constexpr int SA = D_CAT + 2;       // row strides: odd, so a column read by the
constexpr int SB = D_H + 1;         // 16 point groups of a warp spreads over banks

// Packed weights: each matrix (in, out) row-major, followed by its bias.
constexpr int OFF_W0 = 0;
constexpr int OFF_B0 = OFF_W0 + D_IN * D_H;
constexpr int OFF_W1 = OFF_B0 + D_H;
constexpr int OFF_B1 = OFF_W1 + D_H * D_H;
constexpr int OFF_W2 = OFF_B1 + D_H;
constexpr int OFF_B2 = OFF_W2 + D_CAT * D_H;
constexpr int OFF_WA = OFF_B2 + D_H;
constexpr int OFF_BA = OFF_WA + D_H;
constexpr int OFF_WF = OFF_BA + 1;
constexpr int OFF_BF = OFF_WF + D_H * D_H;
constexpr int OFF_WV = OFF_BF + D_H;
constexpr int OFF_BV = OFF_WV + D_CAT * D_VIEW;
constexpr int OFF_WR = OFF_BV + D_VIEW;
constexpr int OFF_BR = OFF_WR + D_VIEW * 3;
constexpr int N_PARAMS = OFF_BR + 3;
static_assert(N_PARAMS == 66884, "packed weight layout");

constexpr size_t SMEM_BYTES =
    sizeof(float) * (TILE_P * SA + TILE_P * SB + KC * D_H);  // 89,600 bytes

__device__ __forceinline__ float softplus(float x) {
  // jax.nn.softplus is logaddexp(x, 0), with no linear cut-off.
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// Round to the input dtype (identity for fp32).
__device__ __forceinline__ float round_as(float x, const float*) { return x; }
__device__ __forceinline__ float round_as(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

// out[p][n] = act(sum_k in[p][k] W[k][n] + b[n]) for the block's TILE_P points.
// Thread t owns points (t / 16) * PPT + i and neurons (t % 16) + 16 j: strided
// neurons make the warp's reads of a staged weight row hit 16 consecutive banks.
// Writes `out` without a trailing barrier: callers never let `out` overlap a
// buffer another thread may still read, and the next layer opens with one.
template <int K, int N, bool SOFTPLUS>
__device__ __forceinline__ void dense(const float* in, int in_stride, float* out,
                                      int out_stride, const float* __restrict__ W,
                                      const float* __restrict__ b, float* wsm) {
  constexpr int NPT = N / 16;
  const int tid = threadIdx.x;
  const int ng = tid & 15;
  const int pg = tid >> 4;
  float acc[PPT][NPT];
#pragma unroll
  for (int j = 0; j < NPT; ++j) {
    const float bj = __ldg(b + ng + 16 * j);
#pragma unroll
    for (int i = 0; i < PPT; ++i) acc[i][j] = bj;
  }
  for (int k0 = 0; k0 < K; k0 += KC) {
    const int kc = min(KC, K - k0);
    __syncthreads();  // earlier readers of wsm and writers of `in` are done
    for (int e = tid; e < kc * N; e += THREADS) wsm[e] = __ldg(W + k0 * N + e);
    __syncthreads();
    for (int kk = 0; kk < kc; ++kk) {
      float a[PPT];
#pragma unroll
      for (int i = 0; i < PPT; ++i) a[i] = in[(pg * PPT + i) * in_stride + k0 + kk];
#pragma unroll
      for (int j = 0; j < NPT; ++j) {
        const float w = wsm[kk * N + ng + 16 * j];
#pragma unroll
        for (int i = 0; i < PPT; ++i) acc[i][j] = fmaf(a[i], w, acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
#pragma unroll
    for (int j = 0; j < NPT; ++j) {
      const float v = SOFTPLUS ? softplus(acc[i][j]) : acc[i][j];
      out[(pg * PPT + i) * out_stride + ng + 16 * j] = v;
    }
  }
}

template <typename T, bool FULL>
__global__ void __launch_bounds__(THREADS)
    fused_decoder_kernel(const T* __restrict__ feats, const T* __restrict__ dirs,
                         const float* __restrict__ w, float* __restrict__ rgb,
                         float* __restrict__ alpha, long long M) {
  extern __shared__ float smem[];
  float* A = smem;                 // [x | h1] then [feat | PE4(d)]
  float* B = A + TILE_P * SA;      // h0, h2, then the 64-wide view hidden
  float* wsm = B + TILE_P * SB;    // staged weight rows

  const int tid = threadIdx.x;
  const long long p0 = (long long)blockIdx.x * TILE_P;
  const long long rest = M - p0;
  const int np = rest < TILE_P ? (int)rest : TILE_P;

  // Features of the tile into A[:, 0:27]; rows past M are zero and never stored.
  const T* fsrc = feats + p0 * D_IN;
  for (int e = tid; e < TILE_P * D_IN; e += THREADS) {
    const int p = e / D_IN;
    A[p * SA + (e - p * D_IN)] = p < np ? load_f32(fsrc + e) : 0.f;
  }

  dense<D_IN, D_H, true>(A, SA, B, SB, w + OFF_W0, w + OFF_B0, wsm);         // h0
  dense<D_H, D_H, true>(B, SB, A + D_IN, SA, w + OFF_W1, w + OFF_B1, wsm);   // [x|h1]
  dense<D_CAT, D_H, true>(A, SA, B, SB, w + OFF_W2, w + OFF_B2, wsm);        // h2

  __syncthreads();
  if (tid < TILE_P) {
    float s = __ldg(w + OFF_BA);
    const float* h = B + tid * SB;
#pragma unroll 8
    for (int k = 0; k < D_H; ++k) s = fmaf(h[k], __ldg(w + OFF_WA + k), s);
    if (tid < np) alpha[p0 + tid] = s;
  }
  if (!FULL) return;

  dense<D_H, D_H, false>(B, SB, A, SA, w + OFF_WF, w + OFF_BF, wsm);         // feat

  // PE4 of the view direction into A[:, 128:155]: [d, sin 2^f d, cos 2^f d].
  if (tid < TILE_P * 3) {
    const int p = tid / 3;
    const int c = tid - 3 * p;
    const float d = p < np ? load_f32(dirs + (p0 + p) * 3 + c) : 0.f;
    float* v = A + p * SA + D_H;
    v[c] = d;
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const float s = d * (float)(1 << f);
      v[3 + 6 * f + c] = round_as(sinf(s), dirs);
      v[6 + 6 * f + c] = round_as(cosf(s), dirs);
    }
  }

  dense<D_CAT, D_VIEW, true>(A, SA, B, SB, w + OFF_WV, w + OFF_BV, wsm);     // view hidden

  __syncthreads();
  if (tid < TILE_P * 3) {
    const int p = tid / 3;
    const int c = tid - 3 * p;
    float s = __ldg(w + OFF_BR + c);
    const float* h = B + p * SB;
#pragma unroll 8
    for (int k = 0; k < D_VIEW; ++k) s = fmaf(h[k], __ldg(w + OFF_WR + 3 * k + c), s);
    if (p < np) rgb[(p0 + p) * 3 + c] = s;
  }
}

template <typename T, bool FULL>
cudaError_t launch(const void* feats, const void* dirs, const void* weights, void* rgb,
                   void* alpha, long long M, cudaStream_t stream) {
  auto kernel = fused_decoder_kernel<T, FULL>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const long long blocks = (M + TILE_P - 1) / TILE_P;
  kernel<<<(unsigned)blocks, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const T*>(feats), static_cast<const T*>(dirs),
      static_cast<const float*>(weights), static_cast<float*>(rgb),
      static_cast<float*>(alpha), M);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// feats (M, 27) and dirs (M, 3): fp32 (bf16_inputs = 0) or bf16 (= 1), contiguous.
// dirs == NULL selects the density-only variant, which writes alpha alone.
// weights: N_PARAMS packed fp32 values; rgb (M, 3) and alpha (M, 1) fp32.
// Returns a cudaError_t (0 on success).
int hl_fused_decoder(const void* feats, const void* dirs, const void* weights, void* rgb,
                     void* alpha, long long M, int bf16_inputs, void* stream) {
  if (M <= 0) return cudaSuccess;
  if ((M + TILE_P - 1) / TILE_P > INT_MAX) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool full = dirs != nullptr;
  if (bf16_inputs) {
    return full ? launch<__nv_bfloat16, true>(feats, dirs, weights, rgb, alpha, M, s)
                : launch<__nv_bfloat16, false>(feats, dirs, weights, rgb, alpha, M, s);
  }
  return full ? launch<float, true>(feats, dirs, weights, rgb, alpha, M, s)
              : launch<float, false>(feats, dirs, weights, rgb, alpha, M, s);
}

int hl_fused_decoder_n_params(void) { return N_PARAMS; }

}  // extern "C"
