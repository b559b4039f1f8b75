// Dynamic-row window gather: 32-column windows of a float32 image, one per
// keypoint, at a per-keypoint row start.
//
// Replaces the Pallas probe kernel `run_variant` (probe_kernel_variants.py),
// the TPU toolchain's test of the constructs the VMEM patch kernel needs.
// Same function: out[k] = P[ys[k] : ys[k] + R, c0 : c0 + 32] of the padded
// image P = pad(img, ((0, 8), (0, 32))), with c0 = 0 (the probe's E1, E2 and
// E5 bodies) or c0 = xs[k] (E3, E4). Reads outside the image are zeros, as
// the padding gives; rows or columns beyond the padding are zeros too.
//
// E3 (a one-hot matrix product selecting columns xs[k]..xs[k]+31) and E4
// (a lane roll by -xs[k]) are two TPU devices for one shifted read; here
// both are the `shifted` case of this one kernel. E1 and E5 differ only in
// the probe's keypoints per program (64 and 8): the grid here does not
// depend on it, so they are the same launch.
//
// What bounds it on the H100: writes. K * R * 32 floats are written (33.5 MB
// at K=8192, R=32) and at most the image is read (1.2 MB at 640x480).
// Design: the output is K * R rows of 128 bytes, 8 float4 each. The grid is
// sized to the card (as many blocks as are resident on every SM, or fewer
// where the output is small) and strides over the output's float4s, so a
// warp writes 4 whole rows (512 contiguous bytes) per store and each thread
// has kUnroll loads in flight before it stores. A row's source is read as
// float4 where it is 16-byte aligned (unshifted windows of an aligned image
// whose width is a multiple of 4), else as 4 floats; the window's keypoint
// and row come from the row index by a division by the constant R.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kCols = 32;
constexpr int kQuads = kCols / 4;  // float4s per window row
constexpr int kThreads = 256;
constexpr int kUnroll = 2;

template <int R, bool kAlignedRows>
__global__ void __launch_bounds__(kThreads)
patch_windows_kernel(const float* __restrict__ img, int H, int W, const int* __restrict__ ys,
                     const int* __restrict__ xs, int total, int shifted, float4* __restrict__ out) {
  const int stride = gridDim.x * kThreads * kUnroll;
  for (int base = blockIdx.x * kThreads * kUnroll + threadIdx.x; base < total; base += stride) {
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int f = base + u * kThreads;
      v[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (f >= total) continue;
      const int row = f / kQuads;
      const int k = row / R;
      const int y = ys[k] + row - k * R;
      if (y < 0 || y >= H) continue;
      const float* src = img + static_cast<size_t>(y) * W;
      if (kAlignedRows) {
        const int x = (f - row * kQuads) * 4;  // a whole float4 lies inside or outside (W % 4 == 0)
        if (x < W) v[u] = *reinterpret_cast<const float4*>(src + x);
      } else {
        const int x = (shifted ? xs[k] : 0) + (f - row * kQuads) * 4;
        float e[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) e[j] = (x + j >= 0 && x + j < W) ? src[x + j] : 0.0f;
        v[u] = make_float4(e[0], e[1], e[2], e[3]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int f = base + u * kThreads;
      if (f < total) out[f] = v[u];
    }
  }
}

template <int R, bool kAlignedRows>
int launch(const float* img, int H, int W, const int* ys, const int* xs, int K, int shifted, float4* out,
           cudaStream_t stream) {
  static int per_sm = 0;  // resident blocks per SM, the same for every call of this instantiation
  if (per_sm == 0) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, patch_windows_kernel<R, kAlignedRows>, kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int total = K * R * kQuads;
  const int needed = (total + kThreads * kUnroll - 1) / (kThreads * kUnroll);
  const int blocks = needed < per_sm * sms ? needed : per_sm * sms;
  patch_windows_kernel<R, kAlignedRows><<<blocks, kThreads, 0, stream>>>(img, H, W, ys, xs, total, shifted,
                                                                          out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int vsf_patch_windows(const void* img, int H, int W, const void* ys, const void* xs,
                                 int K, int rows, int shifted, int block, void* out,
                                 void* stream) {
  // `block` (the probe's keypoints per program) is part of the contract but
  // decides nothing here.
  if (block <= 0 || (rows != 31 && rows != 32) || K <= 0 ||
      static_cast<long long>(K) * rows * kQuads > INT_MAX ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* im = static_cast<const float*>(img);
  const int* y = static_cast<const int*>(ys);
  const int* x = static_cast<const int*>(xs);
  float4* o = static_cast<float4*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned = !shifted && W % 4 == 0 && reinterpret_cast<uintptr_t>(img) % 16 == 0;
  if (rows == 32) {
    return aligned ? launch<32, true>(im, H, W, y, x, K, shifted, o, s)
                   : launch<32, false>(im, H, W, y, x, K, shifted, o, s);
  }
  return aligned ? launch<31, true>(im, H, W, y, x, K, shifted, o, s)
                 : launch<31, false>(im, H, W, y, x, K, shifted, o, s);
}
