// Kernels B2 and B3 for Hopper: the fused int8 MLP fraud scorer.
//
// Replaces the Pallas TPU kernels of ccfd_tpu/ops/fused_mlp_q8.py:
//   B2  _kernel       (entry fused_mlp_q8_score)       -> fused_mlp_q8_kernel
//   B3  _kernel_preq  (entry fused_mlp_q8_score_preq)  -> fused_mlp_q8_preq_kernel
// Both compute the served int8 graph (ccfd_tpu/ops/quant.py logits) with
// its rounding points:
//
//   B2 only:  h0 = x - mu, h = h0 / sigma             IEEE division by raw sigma
//   before each layer, per row:
//             s = max(amax(|h|) / 127, 1e-8)          IEEE division
//             q = clamp(rint(h / s), -127, 127)       rint: half to even
//   B3 starts here, with q and s of layer 1 computed on the host
//   (ops/fused_mlp_q8.py prequantize_rows_numpy) and 34 bytes a row on the wire.
//   layers 1, 2:  acc = q @ Wq (int8 x int8 -> int32 on the tensor cores)
//                 h = relu(((float)acc * s) * scale + b)
//   layer 3:      z = ((float)(q . w3q) * s) * s3 + b3   the int32 dot is exact,
//                 equal to the reference's f32 sum of integers below 2^24
//   p = 1 / (1 + expf(-z))
//
// Every multiply and add of the dequant is an explicit __fmul_rn/__fadd_rn,
// every division __fdiv_rn: nvcc would otherwise contract mul+add into an FMA,
// and a one-ulp change before a requantization moves a quantization step
// (the reference measured up to 4e-3 in p from one such ulp). The library is
// built without --use_fast_math.
//
// What bounds them: a row costs 2 * (30*256 + 256*256 + 256) = 146,944 int8
// operations at H = 256, against 124 bytes of f32 rows and output (B2) or 38
// bytes (B3). At B = 16384 that is 2.41e9 operations, 1.22 us at the H100's
// 1,979 int8 TOP/s, against 0.63 us (B2) or 0.21 us (B3) of HBM traffic, so
// the tensor cores set the bound there; at B = 16 the ~78 KB of weights do.
// Each row also needs ~570 (B2) or ~515 (B3) IEEE divisions on the CUDA cores
// for its requantizations, which chip_smoke.py's timing holds against the
// tensor-core bound.
//
// Design (a simple first version; wgmma, TMA and persistent blocks are later
// work):
// - one block of 8 warps scores a 64-row tile; the ragged last tile is
//   masked, so any batch size is accepted;
// - W1^T (H x 32, K zero-padded to one 32-deep MMA step), W2^T (H x H), w3,
//   the scales and biases, the int8 row tiles and the 64 x H f32 activation
//   tile sit in dynamic shared memory: 174,848 bytes at H = 256; row strides
//   are padded by 16 bytes (8 floats) so the fragment loads and the
//   epilogue's stores hit distinct banks;
// - a row's requantization needs its max over all H columns before any of
//   its elements is quantized, so a block owns whole rows and keeps the
//   tile's f32 activations in shared memory across the reduction: the
//   epilogue of each product writes h and takes each row's max (h >= 0 after
//   relu, so the float bits order like unsigned ints for atomicMax); layer
//   1's normalized input is signed, so its max is taken over fabsf;
// - products are mma.sync.m16n8k32 s8 x s8 -> s32: warp w owns the 16-row
//   slab w % 4 and every other 32-column group, starting at group w / 4;
// - layer 3 quantizes and dots each row against w3 in one pass, one warp per
//   8 rows, with an exact integer warp sum.
//
// Entries: ccfd_fused_mlp_q8 (B2) and ccfd_fused_mlp_q8_preq (B3), plain C
// functions bound with ctypes. Each returns cudaGetLastError() after the
// launch; 1 (cudaErrorInvalidValue) for a shape it does not take.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileRows = 64;
constexpr int kK1 = 32;        // layer-1 depth: features zero-padded to 32
constexpr int kLd1 = kK1 + 16;  // padded row stride (bytes) of the layer-1 operands
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr size_t kSmemLimit = 232448;

struct Smem {
  // byte offsets into the dynamic shared memory, each aligned to 128
  size_t w1t, w2t, hq, xq, hf, w3, vec, sx, amax, total;
  int ldh;  // row stride (bytes) of the int8 layer-2 operands
  int ldf;  // row stride (floats) of the f32 activation tile
};

__host__ __device__ inline size_t align128(size_t n) { return (n + 127) / 128 * 128; }

__host__ __device__ inline Smem smem_layout(int hidden) {
  Smem s;
  s.ldh = hidden + 16;
  s.ldf = hidden + 8;
  size_t off = 0;
  s.w1t = off;  off += align128(static_cast<size_t>(hidden) * kLd1);
  s.w2t = off;  off += align128(static_cast<size_t>(hidden) * s.ldh);
  s.hq = off;   off += align128(static_cast<size_t>(kTileRows) * s.ldh);
  s.xq = off;   off += align128(static_cast<size_t>(kTileRows) * kLd1);
  s.hf = off;   off += align128(sizeof(float) * kTileRows * s.ldf);
  s.w3 = off;   off += align128(hidden);
  s.vec = off;  off += align128(sizeof(float) * 4 * hidden);  // s1, b1, s2, b2
  s.sx = off;   off += align128(sizeof(float) * kTileRows);
  s.amax = off; off += align128(sizeof(unsigned) * kTileRows);
  s.total = off;
  return s;
}

__device__ inline unsigned ld32(const int8_t* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// d += a (16x32, row-major) * b (32x8, col-major), int8 in, int32 sums
__device__ inline void mma_s8(int (&d)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ inline float row_scale(unsigned amax_bits) {
  return fmaxf(__fdiv_rn(__uint_as_float(amax_bits), 127.0f), 1e-8f);
}

__device__ inline int quantize(float h, float s) {
  const float q = rintf(__fdiv_rn(h, s));
  return static_cast<int>(fminf(fmaxf(q, -127.0f), 127.0f));
}

// rows * row_bytes from global (rows packed) to shared (stride ld), 16 B a copy
__device__ inline void copy_rows(int8_t* dst, int ld, const int8_t* src, int row_bytes,
                                 int rows) {
  const int vecs = row_bytes / 16;
  for (int i = threadIdx.x; i < rows * vecs; i += kThreads) {
    const int r = i / vecs, v = i % vecs;
    reinterpret_cast<uint4*>(dst + static_cast<size_t>(r) * ld)[v] =
        reinterpret_cast<const uint4*>(src + static_cast<size_t>(r) * row_bytes)[v];
  }
}

// One int8 dense layer of the tile: hf = relu(((float)(A @ Bt^T) * sx) * scale
// + bias), and each row's max into amax. A is 64 x K int8 (stride lda), Bt is
// hidden x K int8 (W transposed, stride ldb), K a multiple of 32.
__device__ inline void dense_s8(const int8_t* A, int lda, const int8_t* Bt, int ldb,
                                int K, int hidden, const float* scale, const float* bias,
                                float* hf, int ldf, const float* sx, unsigned* amax) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = (warp % 4) * 16 + g, r1 = r0 + 8;
  const float sx0 = sx[r0], sx1 = sx[r1];
  float m0 = 0.0f, m1 = 0.0f;
  for (int n0 = (warp / 4) * 32; n0 < hidden; n0 += 64) {
    int acc[4][4] = {};
    for (int k0 = 0; k0 < K; k0 += 32) {
      unsigned a[4];
      a[0] = ld32(A + r0 * lda + k0 + 4 * t);
      a[1] = ld32(A + r1 * lda + k0 + 4 * t);
      a[2] = ld32(A + r0 * lda + k0 + 16 + 4 * t);
      a[3] = ld32(A + r1 * lda + k0 + 16 + 4 * t);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* brow = Bt + (n0 + j * 8 + g) * ldb + k0 + 4 * t;
        const unsigned b[2] = {ld32(brow), ld32(brow + 16)};
        mma_s8(acc[j], a, b);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = i < 2 ? r0 : r1;
        const int col = n0 + j * 8 + 2 * t + (i & 1);
        float h = __fmul_rn(static_cast<float>(acc[j][i]), i < 2 ? sx0 : sx1);
        h = __fadd_rn(__fmul_rn(h, scale[col]), bias[col]);
        h = h > 0.0f ? h : 0.0f;  // relu to +0, never -0: the row max is taken on the bits
        hf[row * ldf + col] = h;
        if (i < 2) m0 = fmaxf(m0, h); else m1 = fmaxf(m1, h);
      }
    }
  }
  // the row's max over this warp's columns: the 4 lanes of a group share rows
  m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 1));
  m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 2));
  m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 1));
  m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 2));
  if (t == 0) {
    atomicMax(&amax[r0], __float_as_uint(m0));
    atomicMax(&amax[r1], __float_as_uint(m1));
  }
}

// each row's scale from its max, and the max reset for the next reduction
__device__ inline void take_row_scales(float* sx, unsigned* amax) {
  if (threadIdx.x < kTileRows) {
    sx[threadIdx.x] = row_scale(amax[threadIdx.x]);
    amax[threadIdx.x] = 0u;
  }
}

template <bool kPreq>
__device__ __forceinline__ void q8_body(
    const float* __restrict__ x, const float* __restrict__ mu,
    const float* __restrict__ sigma, const int8_t* __restrict__ q_in,
    const float* __restrict__ s_in, const int8_t* __restrict__ w1t,
    const float* __restrict__ s1, const float* __restrict__ b1,
    const int8_t* __restrict__ w2t, const float* __restrict__ s2,
    const float* __restrict__ b2, const int8_t* __restrict__ w3,
    const float* __restrict__ s3, const float* __restrict__ b3,
    float* __restrict__ proba, float* __restrict__ logits, int batch, int features,
    int hidden) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem L = smem_layout(hidden);
  int8_t* w1s = reinterpret_cast<int8_t*>(smem + L.w1t);
  int8_t* w2s = reinterpret_cast<int8_t*>(smem + L.w2t);
  int8_t* hq = reinterpret_cast<int8_t*>(smem + L.hq);
  int8_t* xq = reinterpret_cast<int8_t*>(smem + L.xq);
  float* hf = reinterpret_cast<float*>(smem + L.hf);
  int8_t* w3s = reinterpret_cast<int8_t*>(smem + L.w3);
  float* s1s = reinterpret_cast<float*>(smem + L.vec);
  float* b1s = s1s + hidden;
  float* s2s = b1s + hidden;
  float* b2s = s2s + hidden;
  float* sx = reinterpret_cast<float*>(smem + L.sx);
  unsigned* amax = reinterpret_cast<unsigned*>(smem + L.amax);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int row0 = blockIdx.x * kTileRows;

  // ---- stage the weights ----
  copy_rows(w1s, kLd1, w1t, kK1, hidden);
  copy_rows(w2s, L.ldh, w2t, hidden, hidden);
  for (int i = tid; i < hidden; i += kThreads) {
    w3s[i] = w3[i];
    s1s[i] = s1[i];
    b1s[i] = b1[i];
    s2s[i] = s2[i];
    b2s[i] = b2[i];
  }
  if (tid < kTileRows) amax[tid] = 0u;

  // ---- layer 1's int8 input tile ----
  if constexpr (kPreq) {
    for (int i = tid; i < kTileRows * kK1; i += kThreads) {
      const int r = i / kK1, k = i % kK1, row = row0 + r;
      xq[r * kLd1 + k] = (row < batch && k < features)
                             ? q_in[static_cast<size_t>(row) * features + k]
                             : static_cast<int8_t>(0);
    }
    if (tid < kTileRows) sx[tid] = row0 + tid < batch ? s_in[row0 + tid] : 0.0f;
  } else {
    __syncthreads();  // amax zeroed
    float* hn = hf;   // the normalized 64 x 32 input, stride kK1
    for (int i = tid; i < kTileRows * kK1; i += kThreads) {
      const int r = i / kK1, k = i % kK1, row = row0 + r;
      float v = 0.0f;
      if (row < batch && k < features)
        v = __fdiv_rn(__fsub_rn(x[static_cast<size_t>(row) * features + k], mu[k]),
                      sigma[k]);
      hn[i] = v;
      atomicMax(&amax[r], __float_as_uint(fabsf(v)));
    }
    __syncthreads();
    take_row_scales(sx, amax);
    __syncthreads();
    for (int i = tid; i < kTileRows * kK1; i += kThreads) {
      const int r = i / kK1, k = i % kK1;
      xq[r * kLd1 + k] = static_cast<int8_t>(quantize(hn[i], sx[r]));
    }
  }
  __syncthreads();

  // ---- layer 1 ----
  dense_s8(xq, kLd1, w1s, kLd1, kK1, hidden, s1s, b1s, hf, L.ldf, sx, amax);
  __syncthreads();
  take_row_scales(sx, amax);
  __syncthreads();
  for (int i = tid; i < kTileRows * hidden; i += kThreads) {
    const int r = i / hidden, c = i % hidden;
    hq[r * L.ldh + c] = static_cast<int8_t>(quantize(hf[r * L.ldf + c], sx[r]));
  }
  __syncthreads();

  // ---- layer 2 ----
  dense_s8(hq, L.ldh, w2s, L.ldh, hidden, hidden, s2s, b2s, hf, L.ldf, sx, amax);
  __syncthreads();
  take_row_scales(sx, amax);
  __syncthreads();

  // ---- layer 3: quantize each row and dot it with w3, one warp per 8 rows ----
  for (int rr = 0; rr < kTileRows / kWarps; ++rr) {
    const int r = warp * (kTileRows / kWarps) + rr;
    const float s = sx[r];
    int acc = 0;
    for (int c = lane; c < hidden; c += 32)
      acc += quantize(hf[r * L.ldf + c], s) * static_cast<int>(w3s[c]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    const int row = row0 + r;
    if (lane == 0 && row < batch) {
      const float z = __fadd_rn(
          __fmul_rn(__fmul_rn(static_cast<float>(acc), s), s3[0]), b3[0]);
      proba[row] = 1.0f / (1.0f + expf(-z));
      if (logits != nullptr) logits[row] = z;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
fused_mlp_q8_kernel(const float* __restrict__ x, const float* __restrict__ mu,
                    const float* __restrict__ sigma, const int8_t* __restrict__ w1t,
                    const float* __restrict__ s1, const float* __restrict__ b1,
                    const int8_t* __restrict__ w2t, const float* __restrict__ s2,
                    const float* __restrict__ b2, const int8_t* __restrict__ w3,
                    const float* __restrict__ s3, const float* __restrict__ b3,
                    float* __restrict__ proba, float* __restrict__ logits, int batch,
                    int features, int hidden) {
  q8_body<false>(x, mu, sigma, nullptr, nullptr, w1t, s1, b1, w2t, s2, b2, w3, s3, b3,
                 proba, logits, batch, features, hidden);
}

__global__ void __launch_bounds__(kThreads)
fused_mlp_q8_preq_kernel(const int8_t* __restrict__ q, const float* __restrict__ s,
                         const int8_t* __restrict__ w1t, const float* __restrict__ s1,
                         const float* __restrict__ b1, const int8_t* __restrict__ w2t,
                         const float* __restrict__ s2, const float* __restrict__ b2,
                         const int8_t* __restrict__ w3, const float* __restrict__ s3,
                         const float* __restrict__ b3, float* __restrict__ proba,
                         float* __restrict__ logits, int batch, int features,
                         int hidden) {
  q8_body<true>(nullptr, nullptr, nullptr, q, s, w1t, s1, b1, w2t, s2, b2, w3, s3, b3,
                proba, logits, batch, features, hidden);
}

// the checks both entries share; returns the launch's shared memory or 0
size_t launch_smem(const void* kernel, int batch, int features, int hidden,
                   cudaError_t* err) {
  *err = cudaSuccess;
  if (batch <= 0 || features <= 0 || features > kK1 || hidden < 32 ||
      hidden % 32 != 0) {
    *err = cudaErrorInvalidValue;
    return 0;
  }
  const Smem L = smem_layout(hidden);
  if (L.total > kSmemLimit) {
    *err = cudaErrorInvalidValue;
    return 0;
  }
  *err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(L.total));
  return *err == cudaSuccess ? L.total : 0;
}

}  // namespace

extern "C" int ccfd_fused_mlp_q8(const void* x, const void* mu, const void* sigma,
                                 const void* w1t, const void* s1, const void* b1,
                                 const void* w2t, const void* s2, const void* b2,
                                 const void* w3, const void* s3, const void* b3,
                                 void* proba, void* logits, int batch, int features,
                                 int hidden, void* stream) {
  cudaError_t err;
  const size_t smem = launch_smem(reinterpret_cast<const void*>(fused_mlp_q8_kernel),
                                  batch, features, hidden, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (batch + kTileRows - 1) / kTileRows;
  fused_mlp_q8_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(mu),
      static_cast<const float*>(sigma), static_cast<const int8_t*>(w1t),
      static_cast<const float*>(s1), static_cast<const float*>(b1),
      static_cast<const int8_t*>(w2t), static_cast<const float*>(s2),
      static_cast<const float*>(b2), static_cast<const int8_t*>(w3),
      static_cast<const float*>(s3), static_cast<const float*>(b3),
      static_cast<float*>(proba), static_cast<float*>(logits), batch, features, hidden);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ccfd_fused_mlp_q8_preq(const void* q, const void* s, const void* w1t,
                                      const void* s1, const void* b1, const void* w2t,
                                      const void* s2, const void* b2, const void* w3,
                                      const void* s3, const void* b3, void* proba,
                                      void* logits, int batch, int features, int hidden,
                                      void* stream) {
  cudaError_t err;
  const size_t smem = launch_smem(
      reinterpret_cast<const void*>(fused_mlp_q8_preq_kernel), batch, features, hidden,
      &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (batch + kTileRows - 1) / kTileRows;
  fused_mlp_q8_preq_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(s),
      static_cast<const int8_t*>(w1t), static_cast<const float*>(s1),
      static_cast<const float*>(b1), static_cast<const int8_t*>(w2t),
      static_cast<const float*>(s2), static_cast<const float*>(b2),
      static_cast<const int8_t*>(w3), static_cast<const float*>(s3),
      static_cast<const float*>(b3), static_cast<float*>(proba),
      static_cast<float*>(logits), batch, features, hidden);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ccfd_q8_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
