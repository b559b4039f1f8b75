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
// keypoints per program (64 and 8), which is `block` here.
//
// What bounds it on the H100: a copy. K * R * 32 floats are written (33.5 MB
// at K=8192, R=32) and at most the image is read (1.2 MB at 640x480), so it
// is bound by device-memory bandwidth on the writes. Design: one block of
// 32 x 8 threads per `block` keypoints; a warp copies one 32-float window row
// (128 contiguous bytes read, 128 written), the eight warps walk the rows,
// and every thread reads the keypoint's row and column start (a broadcast).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 32;

__global__ void patch_windows_kernel(const float* __restrict__ img, int H, int W,
                                     const int* __restrict__ ys, const int* __restrict__ xs,
                                     int K, int rows, int shifted, int block,
                                     float* __restrict__ out) {
  const int k0 = blockIdx.x * block;
  const int k_end = min(k0 + block, K);
  const int col = threadIdx.x;
  for (int k = k0; k < k_end; ++k) {
    const int y0 = ys[k];
    const int x = (shifted ? xs[k] : 0) + col;
    float* dst = out + static_cast<size_t>(k) * rows * kCols;
    for (int r = threadIdx.y; r < rows; r += blockDim.y) {
      const int y = y0 + r;
      dst[r * kCols + col] = (y >= 0 && y < H && x >= 0 && x < W)
                                 ? img[static_cast<size_t>(y) * W + x]
                                 : 0.0f;
    }
  }
}

}  // namespace

extern "C" int vsf_patch_windows(const void* img, int H, int W, const void* ys, const void* xs,
                                 int K, int rows, int shifted, int block, void* out,
                                 void* stream) {
  if (block <= 0 || rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 threads(kCols, 8);
  const dim3 grid((K + block - 1) / block);
  patch_windows_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), H, W, static_cast<const int*>(ys),
      static_cast<const int*>(xs), K, rows, shifted, block, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
