"""PyTorch + CUDA port of the stereo SLAM frontend, for one NVIDIA H100.

The JAX package `vision_slam_frontend_tpu` beside it is the reference; this
package mirrors its layout and imports nothing of JAX or of the JAX package.
Ported: the stereo keyframe path from `Frontend.observe_image` to the saved
npz, for the ORB, BRISK, FREAK and AKAZE families and the image pyramid,
with hand-written CUDA kernels for FAST + NMS, patch extraction, Hamming
top-2 and the window gather of the TPU probe (ops/cuda_kernels.py, csrc/).

Layout:
  geometry/  quaternion and camera model ops
  types/     host-side SLAMProblem containers
  ops/       the CUDA kernels and their plain versions, FAST, the four
             descriptor families, the pyramid, matching
  frontend/  keyframe step + host loop
  io/        npz serialization; the synthetic world (numpy)
  utils/     host quaternion helpers (numpy)
  cli/       command-line entry point
"""

__version__ = "0.1.0"
