// Kernel B1 for Hopper: the fused 3-layer MLP fraud scorer in bf16.
//
// Replaces the Pallas TPU kernel ccfd_tpu/ops/fused_mlp.py::_kernel
// (entry fused_mlp_score). It computes what that kernel computes, with the
// same rounding points:
//
//   h1 = bf16_rn(relu(x @ W1 + b1))        x (B, F<=32) bf16, W1 (32, H) bf16
//   h2 = bf16_rn(relu(h1 @ W2 + b2))       W2 (H, H) bf16, f32 accumulation
//   z  = sum_j f32(h2_j) * f32(w3_j) + b3  w3 (H) bf16, an f32 reduce
//   p  = sigmoid(z)
//
// The standardizer is folded into W1/b1 on the host (ops/fused_mlp.py
// fold_for_kernel), and W1's K is zero-padded to 32: the TPU padded to its
// 128-lane width, here 32 is two 16-deep tensor-core steps.
//
// What bounds it: at H = 256 a row costs 2 * (30*256 + 256*256 + 256) =
// 146,432 operations against 60 bytes of input and 4 of output, about
// 2,300 operations per byte, far above the H100's ~295 bf16 operations per
// byte of HBM. So it is bound by the tensor cores, not the memory.
//
// Design (a simple first version; wgmma and TMA are later work):
// - one block of 8 warps scores a 64-row tile; the ragged last tile is
//   masked, so any batch size is accepted;
// - W1 (16 KB at H=256), W2 (128 KB) and the 64 x H bf16 activation tile
//   (32 KB) sit in dynamic shared memory with the staging buffers and
//   biases: 199,680 bytes of the 232,448 a block may have, so one block
//   per SM;
// - products are nvcuda::wmma bf16 16x16x16 with f32 accumulators; each
//   warp owns output tiles in turn, stages its f32 accumulator in a
//   per-warp 16x16 scratch, and applies bias, relu and the bf16 rounding
//   there;
// - layer 3 never materialises h2: each 16x16 tile of h2 reduces against
//   w3 into a per-(row, column tile) partial, and the partials of a row are
//   summed in a fixed order, so the result does not depend on scheduling;
// - x rows are 60 bytes, so they are read element by element (no 16-byte
//   vector loads); weights are read as 16-byte vectors.
//
// Entry: ccfd_fused_mlp_bf16, a plain C function bound with ctypes. It
// returns cudaGetLastError() after the launch; 1 (cudaErrorInvalidValue)
// for a shape it does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int kTileRows = 64;
constexpr int kK1 = 32;  // layer-1 depth: features zero-padded to 32
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxHidden = 256;

struct Smem {
  // byte offsets into the dynamic shared memory, all multiples of 32
  size_t w1, w2, x, h1, stage, partial, b1, b2, w3, total;
};

__host__ __device__ inline Smem smem_layout(int hidden) {
  Smem s;
  size_t off = 0;
  s.w1 = off;      off += sizeof(__nv_bfloat16) * kK1 * hidden;
  s.w2 = off;      off += sizeof(__nv_bfloat16) * hidden * hidden;
  s.x = off;       off += sizeof(__nv_bfloat16) * kTileRows * kK1;
  s.h1 = off;      off += sizeof(__nv_bfloat16) * kTileRows * hidden;
  s.stage = off;   off += sizeof(float) * kWarps * 16 * 16;
  s.partial = off; off += sizeof(float) * kTileRows * (hidden / 16);
  s.b1 = off;      off += sizeof(float) * hidden;
  s.b2 = off;      off += sizeof(float) * hidden;
  s.w3 = off;      off += sizeof(float) * hidden;
  s.total = off;
  return s;
}

// 16-byte vector copy of n_bytes (a multiple of 16) from global to shared
__device__ inline void copy16(void* dst, const void* src, size_t n_bytes) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint4* d = reinterpret_cast<uint4*>(dst);
  for (size_t i = threadIdx.x; i < n_bytes / 16; i += kThreads) d[i] = s[i];
}

__global__ void __launch_bounds__(kThreads)
fused_mlp_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                      const __nv_bfloat16* __restrict__ w1,
                      const float* __restrict__ b1,
                      const __nv_bfloat16* __restrict__ w2,
                      const float* __restrict__ b2,
                      const __nv_bfloat16* __restrict__ w3,
                      const float* __restrict__ b3,
                      float* __restrict__ proba,
                      float* __restrict__ logits,
                      int batch, int features, int hidden) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem L = smem_layout(hidden);
  __nv_bfloat16* w1s = reinterpret_cast<__nv_bfloat16*>(smem + L.w1);
  __nv_bfloat16* w2s = reinterpret_cast<__nv_bfloat16*>(smem + L.w2);
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + L.x);
  __nv_bfloat16* h1s = reinterpret_cast<__nv_bfloat16*>(smem + L.h1);
  float* stage_all = reinterpret_cast<float*>(smem + L.stage);
  float* partial = reinterpret_cast<float*>(smem + L.partial);
  float* b1s = reinterpret_cast<float*>(smem + L.b1);
  float* b2s = reinterpret_cast<float*>(smem + L.b2);
  float* w3s = reinterpret_cast<float*>(smem + L.w3);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = blockIdx.x * kTileRows;
  const int col_tiles = hidden / 16;
  float* stage = stage_all + warp * 256;

  // ---- stage weights and the x tile in shared memory ----
  copy16(w1s, w1, sizeof(__nv_bfloat16) * kK1 * hidden);
  copy16(w2s, w2, sizeof(__nv_bfloat16) * hidden * hidden);
  for (int i = threadIdx.x; i < hidden; i += kThreads) {
    b1s[i] = b1[i];
    b2s[i] = b2[i];
    w3s[i] = __bfloat162float(w3[i]);
  }
  for (int i = threadIdx.x; i < kTileRows * kK1; i += kThreads) {
    const int r = i / kK1, k = i % kK1;
    const int row = row0 + r;
    xs[i] = (row < batch && k < features)
                ? x[static_cast<size_t>(row) * features + k]
                : __float2bfloat16_rn(0.0f);
  }
  __syncthreads();

  // ---- layer 1: h1 = bf16(relu(x @ W1 + b1)) ----
  for (int t = warp; t < 4 * col_tiles; t += kWarps) {
    const int rt = t / col_tiles, ct = t % col_tiles;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int k = 0; k < kK1; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
      wmma::load_matrix_sync(a, xs + rt * 16 * kK1 + k, kK1);
      wmma::load_matrix_sync(b, w1s + k * hidden + ct * 16, hidden);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(stage, acc, 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int r = e / 16, c = ct * 16 + e % 16;
      const float v = fmaxf(stage[e] + b1s[c], 0.0f);
      h1s[(rt * 16 + r) * hidden + c] = __float2bfloat16_rn(v);
    }
    __syncwarp();
  }
  __syncthreads();

  // ---- layer 2 + the layer-3 reduce, tile by tile ----
  for (int t = warp; t < 4 * col_tiles; t += kWarps) {
    const int rt = t / col_tiles, ct = t % col_tiles;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int k = 0; k < hidden; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
      wmma::load_matrix_sync(a, h1s + rt * 16 * hidden + k, hidden);
      wmma::load_matrix_sync(b, w2s + k * hidden + ct * 16, hidden);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(stage, acc, 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int c = ct * 16 + e % 16;
      const float v = fmaxf(stage[e] + b2s[c], 0.0f);
      stage[e] = __bfloat162float(__float2bfloat16_rn(v)) * w3s[c];
    }
    __syncwarp();
    if (lane < 16) {
      float s = 0.0f;
      for (int c = 0; c < 16; ++c) s += stage[lane * 16 + c];
      partial[(rt * 16 + lane) * col_tiles + ct] = s;
    }
    __syncwarp();
  }
  __syncthreads();

  // ---- sum each row's partials in column order, + b3, sigmoid ----
  if (threadIdx.x < kTileRows) {
    const int row = row0 + threadIdx.x;
    if (row < batch) {
      float z = 0.0f;
      for (int ct = 0; ct < col_tiles; ++ct)
        z += partial[threadIdx.x * col_tiles + ct];
      z += b3[0];
      proba[row] = 1.0f / (1.0f + expf(-z));
      if (logits != nullptr) logits[row] = z;
    }
  }
}

}  // namespace

extern "C" int ccfd_fused_mlp_bf16(const void* x, const void* w1, const void* b1,
                                   const void* w2, const void* b2, const void* w3,
                                   const void* b3, void* proba, void* logits,
                                   int batch, int features, int hidden,
                                   void* stream) {
  if (batch <= 0 || features <= 0 || features > kK1 || hidden < 16 ||
      hidden > kMaxHidden || hidden % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Smem L = smem_layout(hidden);
  cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L.total));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (batch + kTileRows - 1) / kTileRows;
  fused_mlp_bf16_kernel<<<blocks, kThreads, L.total,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w1), static_cast<const float*>(b1),
      static_cast<const __nv_bfloat16*>(w2), static_cast<const float*>(b2),
      static_cast<const __nv_bfloat16*>(w3), static_cast<const float*>(b3),
      static_cast<float*>(proba), static_cast<float*>(logits), batch, features,
      hidden);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ccfd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
