"""PyTorch + CUDA port of the stereo SLAM frontend, for one NVIDIA H100.

The JAX package `vision_slam_frontend_tpu` beside it is the reference; this
package mirrors its layout and imports no JAX. Ported slice: the default
stereo keyframe path (ORB, one pyramid level) from `Frontend.observe_image`
to the saved npz, with hand-written CUDA kernels for FAST + NMS, patch
extraction and Hamming top-2 (ops/cuda_kernels.py, csrc/).

Layout:
  geometry/  quaternion and camera model ops
  types/     host-side SLAMProblem containers
  ops/       the CUDA kernels and their plain versions, FAST, BRIEF, matching
  frontend/  keyframe step + host loop
  io/        npz serialization; the synthetic world (shared, pure numpy)
  utils/     host quaternion helpers (shared, pure numpy)
  cli/       command-line entry point
"""

__version__ = "0.1.0"
