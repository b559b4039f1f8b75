// FAST-9 corner score + strict 3x3 non-maximum suppression over a uint8 or
// float32 image (float32: the resized levels of the image pyramid).
//
// Replaces the Pallas kernel `fast_scores_nms` / `_fast_kernel`
// (vision_slam_frontend_tpu/ops/pallas_kernels.py). Same contract: the score
// of a pixel is the max over both polarities and the 16 start positions of
// the minimum signed (ring - centre) difference along a 9-pixel arc of the
// radius-3 Bresenham ring; `suppressed` keeps a score only where it is
// strictly greater than all 8 neighbours (-inf elsewhere). The image is
// zero-padded outside its bounds, as the Pallas kernel pads it.
//
// What bounds it on the H100: it reads H*W pixels (1 or 4 bytes each) and
// writes 8*H*W bytes (two f32 maps, 2.5 MB at 640x480), far below what the
// card moves in a few microseconds; the 16 arcs x 9 taps x 2 polarities of
// min/max per pixel are the work. Design: one block per 32x16 output tile.
// The tile and its 4-pixel halo (ring radius 3 + NMS radius 1) are loaded
// once into shared memory as float (a uint8 converts exactly); scores for the tile plus a 1-pixel ring go to shared memory;
// the NMS reads its 8 neighbours from there. Every image byte is read from
// device memory once per tile, and the score map never goes through device
// memory between the score and the NMS pass.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTileW = 32;
constexpr int kTileH = 16;
constexpr int kHalo = 4;
constexpr int kSmemW = kTileW + 2 * kHalo;  // 40
constexpr int kSmemH = kTileH + 2 * kHalo;  // 24
constexpr int kScoreW = kTileW + 2;         // tile + 1-pixel NMS ring
constexpr int kScoreH = kTileH + 2;

// Offset of ring pixel (dy, dx) in the row-major shared tile.
__host__ __device__ constexpr int ring(int dy, int dx) { return dy * kSmemW + dx; }

// The score in float. Every ring - centre difference is one rounded f32
// subtraction, as in the reference; min, max and negation are exact. For a
// uint8 image the values are integers in [-255, 255]. (The same max-of-min
// chain in int, built with nvcc 12.9 for sm_90a at ptxas -O1 or above,
// returned max(ring - centre) instead; the float form is right at every
// level.)
__device__ __forceinline__ float fast_score(const float* tile, int sy, int sx) {
  const float* p = tile + sy * kSmemW + sx;
  const float c = p[0];
  // The ring, clockwise from 12 o'clock (ops/fast.py RING_OFFSETS), minus the centre.
  const float d[16] = {
      p[ring(-3, 0)] - c, p[ring(-3, 1)] - c, p[ring(-2, 2)] - c, p[ring(-1, 3)] - c,
      p[ring(0, 3)] - c, p[ring(1, 3)] - c, p[ring(2, 2)] - c, p[ring(3, 1)] - c,
      p[ring(3, 0)] - c, p[ring(3, -1)] - c, p[ring(2, -2)] - c, p[ring(1, -3)] - c,
      p[ring(0, -3)] - c, p[ring(-1, -3)] - c, p[ring(-2, -2)] - c, p[ring(-3, -1)] - c,
  };
  float best = -INFINITY;
#pragma unroll
  for (int s = 0; s < 16; ++s) {
    float lo = d[s];
    float hi = d[s];
#pragma unroll
    for (int k = 1; k < 9; ++k) {
      lo = fminf(lo, d[(s + k) & 15]);
      hi = fmaxf(hi, d[(s + k) & 15]);
    }
    // Bright arc: min over the arc of (ring - centre) = lo.
    // Dark arc: min over the arc of (centre - ring) = -hi.
    best = fmaxf(best, fmaxf(lo, -hi));
  }
  return best;
}

template <typename T>
__global__ void fast_nms_kernel(const T* __restrict__ img, int H, int W,
                                float* __restrict__ raw, float* __restrict__ sup) {
  __shared__ float tile[kSmemH][kSmemW];
  __shared__ float score[kScoreH][kScoreW];
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;

  for (int i = tid; i < kSmemH * kSmemW; i += nthreads) {
    const int ty = i / kSmemW;
    const int tx = i - ty * kSmemW;
    const int gy = y0 - kHalo + ty;
    const int gx = x0 - kHalo + tx;
    tile[ty][tx] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                       ? static_cast<float>(img[static_cast<size_t>(gy) * W + gx])
                       : 0.0f;
  }
  __syncthreads();

  // Score pixel (cy, cx) is image pixel (y0 - 1 + cy, x0 - 1 + cx).
  for (int i = tid; i < kScoreH * kScoreW; i += nthreads) {
    const int cy = i / kScoreW;
    const int cx = i - cy * kScoreW;
    score[cy][cx] = fast_score(&tile[0][0], cy + kHalo - 1, cx + kHalo - 1);
  }
  __syncthreads();

  for (int i = tid; i < kTileH * kTileW; i += nthreads) {
    const int oy = i / kTileW;
    const int ox = i - oy * kTileW;
    const int gy = y0 + oy;
    const int gx = x0 + ox;
    if (gy >= H || gx >= W) continue;
    const float c = score[oy + 1][ox + 1];
    float m = -INFINITY;
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
      for (int dx = -1; dx <= 1; ++dx) {
        if (dy != 0 || dx != 0) m = fmaxf(m, score[oy + 1 + dy][ox + 1 + dx]);
      }
    }
    const size_t o = static_cast<size_t>(gy) * W + gx;
    raw[o] = c;
    sup[o] = c > m ? c : -INFINITY;
  }
}

}  // namespace

// is_float: 0 for a uint8 image, 1 for a float32 one.
extern "C" int vsf_fast_scores_nms(const void* img, int is_float, int H, int W, void* raw,
                                   void* sup, void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* r = static_cast<float*>(raw);
  float* o = static_cast<float*>(sup);
  if (is_float) {
    fast_nms_kernel<float><<<grid, block, 0, s>>>(static_cast<const float*>(img), H, W, r, o);
  } else {
    fast_nms_kernel<uint8_t><<<grid, block, 0, s>>>(static_cast<const uint8_t*>(img), H, W, r, o);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* vsf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
