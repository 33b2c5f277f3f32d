// Fused NeRF decoder MLP for Hopper (sm_90a): one kernel per decoder call,
// every dense layer on the tensor cores in split TF32 (3xTF32).
//
// Replaces humanliff_tpu/ops/pallas/decoder.py::fused_decoder, the Pallas TPU
// kernel launched by pl.pallas_call at ops/pallas/decoder.py:80 (body `_kernel`,
// :46-69). Per sample point it computes what nerf/decoder.py::NeRFDecoder does:
//   trunk  h = softplus(x W0 + b0); h = softplus(h W1 + b1);
//          h = softplus([x, h] W2 + b2)                       (27 -> 128 -> 128 -> 128)
//   heads  alpha = h Wa + ba;  feat = h Wf + bf               (128 -> 1, 128 -> 128)
//   view   rgb = softplus([feat, PE4(d)] Wv + bv) Wr + br     (155 -> 64 -> 3)
// PE4(d) = [d, sin d, cos d, sin 2d, cos 2d, sin 4d, cos 4d, sin 8d, cos 8d] in
// 3-wide blocks, rounded to bf16 for bf16 directions. softplus is
// logaddexp(x, 0).
// The density-only variant (FULL = false) stops after alpha: the renderer's
// coarse pass needs no colour.
//
// Precision decides the arithmetic. The kernel is held to its plain fp32
// version at 1e-4 + 1e-5 max|ref| (fp32 inputs) with outputs near 600, so an
// absolute 6e-3. One bf16 or TF32 tensor-core pass misses that by 10^3 and
// 10^2; split TF32 (3xTF32) meets it at the size of fp32's own rounding. Each
// operand v becomes hi and lo = v - hi, and a product is lo.hi + hi.lo + hi.hi,
// accumulated in fp32 by mma.sync.m16n8k8 (lo.lo, below 2^-21 of the product,
// is dropped). An activation's hi is v rounded to TF32 (to nearest, ties away
// from zero, as cvt.rna); a weight's hi is v truncated, one operation fewer
// on the path every weight takes at every use. lo goes to the tensor core as
// it is: the unit reads the upper 19 bits of a TF32 operand, so lo is
// truncated there (tests/test_torch_cuda_kernels.py checks this on the card).
// tests/test_torch_decoder_precision.py emulates this arithmetic. bf16 inputs
// (and PE4 of bf16 directions) are exact in TF32, so their lo.hi is skipped.
//
// What bounds it on an H100: operations, of two kinds. Per point 66,304
// multiply-adds (39,808 density-only), three TF32 products each (two for the
// 8,640 whose activation is exact, with bf16 inputs): 3.22 ms for a render
// chunk's 4,194,304-point bf16 fine pass at the 495 TFLOP/s dense TF32
// peak. And the special-function units: 448 softplus per point (384
// density-only), each one ex2 and one lg2, and 24 sin/cos: 1.00 ms at
// 132 SMs x 16 per clock x 1.83 GHz, the clock that peak implies. The bytes
// (30 inputs, 4 outputs per point) take 0.1-0.2 ms. So the design keeps the
// tensor cores fed:
//   - a warp owns 16 points x all neurons of a layer as mma accumulators
//     (64 fp32 registers) and the previous layer's output (64 more): the
//     activations never leave registers. The K rows of every packed weight
//     matrix are permuted so that an m16n8 accumulator fragment is the next
//     layer's A fragment as it stands: A column t holds neuron 2t and column
//     t+4 neuron 2t+1 of each 8-wide k-tile. x (27 -> 32 columns) stays in
//     registers for the skip concat of W2, and PE4(d) is computed straight
//     into A-fragment positions for Wv. 194-254 registers a thread, no spills;
//   - a block is 8 warps, a tile is 128 points, and the block is persistent
//     (one block per SM, looping over tiles), so each SM stages the weights
//     once and not once per tile. The weights are packed in B-fragment order,
//     so a lane reads two n-tiles' fragments with one conflict-free 16-byte
//     shared-memory load and splits them into hi and lo in registers (one
//     fp32 copy in shared memory);
//   - shared memory: the density-only variant holds all its weights
//     (170,304 bytes) for the kernel's life. The full variant's 278,848 bytes
//     do not fit in 227 KB, so W0, W2, Wa, Wv, Wr and the biases stay resident
//     and one 64 KB buffer takes W1 and Wf in turn (213,312 bytes in all).
//     cp.async brings Wf into the buffer while W2 and the alpha head run, and
//     the next tile's W1 while the view branch runs: 128 KB of L2 reads per
//     128-point tile, 1 KB per point (the density-only variant: none after
//     its first tile);
//   - the heads (N = 1 and N = 3) are one zero-padded n-tile each, with their
//     k-tiles spread over four accumulators so the mma chain is not serial;
//   - softplus runs as max(x, 0) + log(1 + exp(-|x|)) on the special-function
//     units (__expf, __logf: one ex2 and one lg2 each).
// What holds it at about 3x its bound: mma.sync ran TF32 at 314 TFLOP/s at
// most on an H100 (63 % of the peak), and with 8 warps an SM cannot hide the
// loads and splits on each weight's way to the tensor core; 12 warps would
// hide more, but leave 168 registers a thread and spill (PERF.md). The next
// step is wgmma, which reads B from shared memory: the weights' hi and lo
// halves would both be staged, twice the shared memory, so every layer would
// stream through a ring of K-chunks (TMA and mbarriers); then fusing the
// tri-plane sampler in front of the first layer. Ragged M is masked in the
// kernel (no padding copy). The launcher runs on the caller's stream,
// allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int LAYOUT_VERSION = 2;  // of the packed weights below

constexpr int THREADS = 256;  // 8 warps
constexpr int WARP_P = 16;    // points per warp: one mma m-tile
constexpr int TILE_P = (THREADS / 32) * WARP_P;  // 128 points per tile

// k-tiles (8 rows) and n-tiles (8 columns) of the padded layers.
constexpr int KT_X = 4;   // x: 27 features padded to 32
constexpr int KT_H = 16;  // a 128-wide activation
constexpr int KT_PE = 4;  // PE4(d): 27 values padded to 32
constexpr int KT_V = 8;   // the 64-wide view hidden
constexpr int NT_H = 16;
constexpr int NT_V = 8;

// Packed weights, fp32. A matrix W (in, out), padded to (8 KT, 8 NT) with
// zeros, is stored as mma B fragments: for k-tile kt, n-tile j, lane (g, t)
// = (lane / 4, lane % 4) and r in {0, 1}, the value W[8 kt + 2 t + r][8 j + g].
// Two n-tiles share a lane's 16 bytes: index ((kt NT/2 + j/2) 32 + lane) 4 +
// (j % 2) 2 + r; a one-n-tile head is (kt 32 + lane) 2 + r. W2's K is
// [x (27 rows, padded to 32), h (128)]; Wv's is [feat (128), PE4 (27, padded
// to 32)]. The order below puts the density-only variant's weights and all
// the biases first, and Wf last, so each variant stages a prefix.
constexpr int FRAG = 64;  // floats of one (k-tile, n-tile) fragment
constexpr int SZ_W0 = KT_X * NT_H * FRAG;            // 4,096
constexpr int SZ_W1 = KT_H * NT_H * FRAG;            // 16,384
constexpr int SZ_W2 = (KT_X + KT_H) * NT_H * FRAG;   // 20,480
constexpr int SZ_WA = KT_H * FRAG;                   // 1,024
constexpr int SZ_B = 3 * 128 + 8 + 128 + 64 + 8;     // 592: b0 b1 b2 ba bf bv br
constexpr int SZ_WV = (KT_H + KT_PE) * NT_V * FRAG;  // 10,240
constexpr int SZ_WR = KT_V * FRAG;                   // 512
constexpr int SZ_WF = SZ_W1;

constexpr int OFF_W0 = 0;
constexpr int OFF_W1 = OFF_W0 + SZ_W0;
constexpr int OFF_W2 = OFF_W1 + SZ_W1;
constexpr int OFF_WA = OFF_W2 + SZ_W2;
constexpr int OFF_B0 = OFF_WA + SZ_WA;
constexpr int OFF_B1 = OFF_B0 + 128;
constexpr int OFF_B2 = OFF_B1 + 128;
constexpr int OFF_BA = OFF_B2 + 128;  // 8: ba, then zeros
constexpr int OFF_BF = OFF_BA + 8;
constexpr int OFF_BV = OFF_BF + 128;
constexpr int OFF_BR = OFF_BV + 64;   // 8: br (3), then zeros
constexpr int OFF_WV = OFF_B0 + SZ_B;
constexpr int OFF_WR = OFF_WV + SZ_WV;
constexpr int OFF_WF = OFF_WR + SZ_WR;
constexpr int N_PACKED = OFF_WF + SZ_WF;
static_assert(N_PACKED == 69712, "packed weight layout");
static_assert(OFF_WV % 4 == 0 && OFF_WF % 4 == 0 && SZ_W1 % 4 == 0, "16-byte copies");

// Shared memory mirrors a prefix of the packed buffer. The full variant's
// W1 slot [OFF_W1, OFF_W1 + SZ_W1) is the buffer that holds W1 and Wf in turn.
constexpr int SMEM_DENSITY = OFF_WV * 4;  // 170,304 bytes
constexpr int SMEM_FULL = OFF_WF * 4;     // 213,312 bytes
static_assert(SMEM_FULL <= 232448, "a block holds at most 227 KB");

// ---------------------------------------------------------------- helpers

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

// Start the copy of n floats (a multiple of 4) by the whole block, as one group.
__device__ __forceinline__ void stage(float* dst, const float* src, int n) {
  for (int i = 4 * threadIdx.x; i < n; i += 4 * THREADS) cp_async16(dst + i, src + i);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void staged_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// An activation: hi = v rounded to TF32, to nearest with ties away from zero
// (cvt.rna); lo = v - hi, exact in fp32 (the tensor core truncates it).
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// A weight, split at every use: hi = v truncated to TF32, lo = v - hi. One
// operation fewer than rounding, on the kernel's critical path.
__device__ __forceinline__ void split_weight(float v, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(v) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a w for one k-tile and one n-tile, in 3xTF32: lo.hi + hi.lo + hi.hi.
// EXACT: a is exact in TF32 (its lo is zero), so lo.hi is skipped.
template <bool EXACT>
__device__ __forceinline__ void product(float (&d)[4], const uint32_t (&ah)[4],
                                        const uint32_t (&al)[4], float w0, float w1) {
  uint32_t bh0, bl0, bh1, bl1;
  split_weight(w0, bh0, bl0);
  split_weight(w1, bh1, bl1);
  if (!EXACT) mma(d, al, bh0, bh1);
  mma(d, ah, bl0, bl1);
  mma(d, ah, bh0, bh1);
}

// An activation strip a[kt] holds, per lane (g, t), the values at rows g and
// g + 8 and columns 8 kt + 2 t + {0, 1} in accumulator order {c0, c1, c2, c3} =
// {(g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)}. As an A fragment, {a0 .. a3} =
// {(g, t), (g+8, t), (g, t+4), (g+8, t+4)} = {c0, c2, c1, c3}.
template <bool EXACT>
__device__ __forceinline__ void a_fragment(const float (&c)[4], uint32_t (&ah)[4],
                                           uint32_t (&al)[4]) {
  const float v[4] = {c[0], c[2], c[1], c[3]};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (EXACT) {
      ah[i] = __float_as_uint(v[i]);
      al[i] = 0u;
    } else {
      split(v[i], ah[i], al[i]);
    }
  }
}

// acc[j] += a W over KT k-tiles and NT (even) n-tiles; w points at this K
// range's first k-tile of the fragment-ordered matrix in shared memory.
template <int KT, int NT, bool EXACT>
__device__ __forceinline__ void dense(float (&acc)[NT][4], const float (&a)[KT][4],
                                      const float* w, int lane) {
  static_assert(NT % 2 == 0, "n-tiles are read in pairs");
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
    uint32_t ah[4], al[4];
    a_fragment<EXACT>(a[kt], ah, al);
#pragma unroll
    for (int jp = 0; jp < NT / 2; ++jp) {
      const float4 b =
          *reinterpret_cast<const float4*>(w + ((kt * (NT / 2) + jp) * 32 + lane) * 4);
      product<EXACT>(acc[2 * jp], ah, al, b.x, b.y);
      product<EXACT>(acc[2 * jp + 1], ah, al, b.z, b.w);
    }
  }
}

// A one-n-tile head: out = a W + bias over KT k-tiles, the k-tiles spread over
// four accumulators so that consecutive mma do not wait on each other.
template <int KT>
__device__ __forceinline__ void head(float (&out)[4], const float (&a)[KT][4],
                                     const float* w, const float* bias, int lane) {
  constexpr int P = 4;
  static_assert(KT % P == 0, "head k-tiles");
  float acc[P][4];
  const float2 b = *reinterpret_cast<const float2*>(bias + 2 * (lane & 3));
#pragma unroll
  for (int p = 0; p < P; ++p) {
    acc[p][0] = p ? 0.f : b.x;
    acc[p][1] = p ? 0.f : b.y;
    acc[p][2] = p ? 0.f : b.x;
    acc[p][3] = p ? 0.f : b.y;
  }
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
    uint32_t ah[4], al[4];
    a_fragment<false>(a[kt], ah, al);
    const float2 wf = *reinterpret_cast<const float2*>(w + (kt * 32 + lane) * 2);
    product<false>(acc[kt % P], ah, al, wf.x, wf.y);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) out[i] = (acc[0][i] + acc[1][i]) + (acc[2][i] + acc[3][i]);
}

template <int NT>
__device__ __forceinline__ void init_bias(float (&acc)[NT][4], const float* bias, int t) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const float2 b = *reinterpret_cast<const float2*>(bias + 8 * j + 2 * t);
    acc[j][0] = b.x;
    acc[j][1] = b.y;
    acc[j][2] = b.x;
    acc[j][3] = b.y;
  }
}

__device__ __forceinline__ float softplus(float x) {
  // logaddexp(x, 0) = max(x, 0) + log(1 + exp(-|x|)): one ex2, one lg2.
  return fmaxf(x, 0.f) + __logf(1.f + __expf(-fabsf(x)));
}

template <int NT>
__device__ __forceinline__ void softplus_all(float (&acc)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = softplus(acc[j][i]);
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

// PE4 value i of direction d (i >= 27 is padding): [d, sin 2^f d, cos 2^f d].
// The angle is reduced to [-pi, pi] (two-constant Cody-Waite) and sin or cos
// taken on the special-function unit: absolute error about 4e-7 there, and no
// local memory (sincosf's reduction of large arguments keeps an array there).
template <typename T>
__device__ __forceinline__ float pe4(int i, float d0, float d1, float d2, const T* tag) {
  if (i >= 27) return 0.f;
  const int c = i < 3 ? i : (i - 3) % 3;
  const float d = c == 0 ? d0 : (c == 1 ? d1 : d2);
  if (i < 3) return d;
  const float x = d * (float)(1 << ((i - 3) / 6));
  const float k = rintf(x * 0.15915494309189535f);  // 1 / (2 pi)
  const float r = fmaf(k, 1.7484556e-07f, fmaf(-k, 6.28318548202514648f, x));
  return round_as((i - 3) % 6 < 3 ? __sinf(r) : __cosf(r), tag);
}

// ---------------------------------------------------------------- kernel

template <typename T, bool FULL>
__global__ void __launch_bounds__(THREADS, 1)
    fused_decoder_kernel(const T* __restrict__ feats, const T* __restrict__ dirs,
                         const float* __restrict__ w, float* __restrict__ rgb,
                         float* __restrict__ alpha, long long M, long long n_tiles) {
  constexpr bool IN_EXACT = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ float4 smem4[];
  float* s = reinterpret_cast<float*>(smem4);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;

  // The resident weights (and, for the full variant, W1 into the buffer).
  stage(s, w, FULL ? OFF_WF : OFF_WV);
  staged_wait();
  __syncthreads();

  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long r0 = tile * TILE_P + warp * WARP_P + g;  // rows r0 and r0 + 8
    const bool v0 = r0 < M;
    const bool v1 = r0 + 8 < M;

    // x in A-fragment positions: columns 8 kt + 2 t + {0, 1}, zero past 27.
    float x[KT_X][4];
#pragma unroll
    for (int kt = 0; kt < KT_X; ++kt) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int col = 8 * kt + 2 * t + r;
        x[kt][r] = v0 && col < 27 ? load_f32(feats + r0 * 27 + col) : 0.f;
        x[kt][2 + r] = v1 && col < 27 ? load_f32(feats + (r0 + 8) * 27 + col) : 0.f;
      }
    }

    float h[NT_H][4], o[NT_H][4];
    init_bias(o, s + OFF_B0, t);
    dense<KT_X, NT_H, IN_EXACT>(o, x, s + OFF_W0, lane);
    softplus_all(o);

    if (FULL) {  // W1 is in the buffer
      staged_wait();
      __syncthreads();
    }
    init_bias(h, s + OFF_B1, t);
    dense<KT_H, NT_H, false>(h, o, s + OFF_W1, lane);
    softplus_all(h);
    if (FULL) {  // every warp is done with W1: bring Wf into the buffer
      __syncthreads();
      stage(s + OFF_W1, w + OFF_WF, SZ_WF);
    }

    init_bias(o, s + OFF_B2, t);
    dense<KT_X, NT_H, IN_EXACT>(o, x, s + OFF_W2, lane);
    dense<KT_H, NT_H, false>(o, h, s + OFF_W2 + KT_X * NT_H * FRAG, lane);
    softplus_all(o);

    float a[4];
    head<KT_H>(a, o, s + OFF_WA, s + OFF_BA, lane);
    if (t == 0) {
      if (v0) alpha[r0] = a[0];
      if (v1) alpha[r0 + 8] = a[2];
    }
    if (!FULL) continue;

    staged_wait();  // Wf is in the buffer
    __syncthreads();
    init_bias(h, s + OFF_BF, t);
    dense<KT_H, NT_H, false>(h, o, s + OFF_W1, lane);  // feat: no activation
    __syncthreads();  // every warp is done with Wf: bring the next tile's W1
    stage(s + OFF_W1, w + OFF_W1, SZ_W1);

    float pe[KT_PE][4];
    {
      float d[2][3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        d[0][c] = v0 ? load_f32(dirs + r0 * 3 + c) : 0.f;
        d[1][c] = v1 ? load_f32(dirs + (r0 + 8) * 3 + c) : 0.f;
      }
#pragma unroll
      for (int kt = 0; kt < KT_PE; ++kt) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = 8 * kt + 2 * t + r;
          pe[kt][r] = pe4(i, d[0][0], d[0][1], d[0][2], dirs);
          pe[kt][2 + r] = pe4(i, d[1][0], d[1][1], d[1][2], dirs);
        }
      }
    }
    float v[NT_V][4];
    init_bias(v, s + OFF_BV, t);
    dense<KT_H, NT_V, false>(v, h, s + OFF_WV, lane);
    dense<KT_PE, NT_V, IN_EXACT>(v, pe, s + OFF_WV + KT_H * NT_V * FRAG, lane);
    softplus_all(v);

    float c[4];
    head<KT_V>(c, v, s + OFF_WR, s + OFF_BR, lane);
    // Columns 2t, 2t + 1 of rows r0 and r0 + 8; rgb is columns 0-2.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int col = 2 * t + r;
      if (col < 3) {
        if (v0) rgb[r0 * 3 + col] = c[r];
        if (v1) rgb[(r0 + 8) * 3 + col] = c[2 + r];
      }
    }
  }
  staged_wait();  // the last tile's W1 copy: no block exits with copies in flight
}

template <typename T, bool FULL>
cudaError_t launch(const void* feats, const void* dirs, const void* weights, void* rgb,
                   void* alpha, long long M, cudaStream_t stream) {
  auto kernel = fused_decoder_kernel<T, FULL>;
  constexpr int smem = FULL ? SMEM_FULL : SMEM_DENSITY;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long tiles = (M + TILE_P - 1) / TILE_P;
  const int blocks = (int)(tiles < sms ? tiles : sms);  // persistent: one per SM
  kernel<<<blocks, THREADS, smem, stream>>>(
      static_cast<const T*>(feats), static_cast<const T*>(dirs),
      static_cast<const float*>(weights), static_cast<float*>(rgb),
      static_cast<float*>(alpha), M, tiles);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// feats (M, 27) and dirs (M, 3): fp32 (bf16_inputs = 0) or bf16 (= 1), contiguous.
// dirs == NULL selects the density-only variant, which writes alpha alone.
// weights: the packed fp32 buffer of layout hl_fused_decoder_layout(), 16-byte
// aligned; rgb (M, 3) and alpha (M, 1) fp32. Returns a cudaError_t (0 on success).
int hl_fused_decoder(const void* feats, const void* dirs, const void* weights, void* rgb,
                     void* alpha, long long M, int bf16_inputs, void* stream) {
  if (M <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool full = dirs != nullptr;
  if (bf16_inputs) {
    return full ? launch<__nv_bfloat16, true>(feats, dirs, weights, rgb, alpha, M, s)
                : launch<__nv_bfloat16, false>(feats, dirs, weights, rgb, alpha, M, s);
  }
  return full ? launch<float, true>(feats, dirs, weights, rgb, alpha, M, s)
              : launch<float, false>(feats, dirs, weights, rgb, alpha, M, s);
}

// The packed weight layout this library reads (see the note above the offsets).
int hl_fused_decoder_layout(void) { return LAYOUT_VERSION; }

}  // extern "C"
