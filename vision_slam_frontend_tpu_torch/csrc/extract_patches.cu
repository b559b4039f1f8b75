// Square patch extraction around keypoints from a stack of image planes.
//
// Replaces the Pallas kernel `extract_patches_vmem` / `_extract_patches_kernel`
// (vision_slam_frontend_tpu/ops/pallas_kernels.py). Same contract: patch k of
// plane c is the ps x ps window whose top-left corner is
// clip(round(kp) - ps // 2, 0, dim - ps), with round-half-to-even, written
// row-major to out[k, c, :]. The values are copied bit for bit, so the kernel
// is the same for f16 and f32 planes (the ORB path reads f16).
//
// What bounds it on the H100: a gather of K * C * ps^2 elements (512 x 961 x
// 2 B = 1 MB on the ORB path) whose rows are only ps elements long, so the
// cost is the number of short row transactions and the launch, not bytes.
// Design: one block per keypoint; each thread copies elements strided by the
// block size, so a warp reads consecutive elements of one or two patch rows.
// The start rounds with __float2int_rn (half to even, never roundf): the
// sub-pixel fit clips its offset to +-0.5, so keypoints sit exactly on .5.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
__global__ void extract_patches_kernel(const T* __restrict__ planes, int C, int H, int W,
                                       const float* __restrict__ kps, int ps,
                                       T* __restrict__ out) {
  const int k = blockIdx.x;
  const int r = ps / 2;
  const int sx = min(max(__float2int_rn(kps[2 * k]) - r, 0), W - ps);
  const int sy = min(max(__float2int_rn(kps[2 * k + 1]) - r, 0), H - ps);
  const int area = ps * ps;
  T* dst = out + static_cast<size_t>(k) * C * area;
  for (int i = threadIdx.x; i < C * area; i += blockDim.x) {
    const int c = i / area;
    const int j = i - c * area;
    const int py = j / ps;
    const int px = j - py * ps;
    dst[i] = planes[(static_cast<size_t>(c) * H + sy + py) * W + sx + px];
  }
}

}  // namespace

extern "C" int vsf_extract_patches(const void* planes, int elem_bytes, int C, int H, int W,
                                   const void* kps, int K, int ps, void* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* k = static_cast<const float*>(kps);
  if (elem_bytes == 2) {
    extract_patches_kernel<uint16_t><<<K, 128, 0, s>>>(
        static_cast<const uint16_t*>(planes), C, H, W, k, ps, static_cast<uint16_t*>(out));
  } else if (elem_bytes == 4) {
    extract_patches_kernel<uint32_t><<<K, 128, 0, s>>>(
        static_cast<const uint32_t*>(planes), C, H, W, k, ps, static_cast<uint32_t*>(out));
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
