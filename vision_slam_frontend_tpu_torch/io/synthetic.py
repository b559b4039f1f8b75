"""The synthetic stereo world, shared with the JAX package.

`vision_slam_frontend_tpu.io.synthetic` is pure numpy and loads no JAX, so
the port uses it as it is; this module is the port's one door to it.
"""

from vision_slam_frontend_tpu.io.synthetic import SyntheticRig, StereoFrame, generate_sequence

__all__ = ["SyntheticRig", "StereoFrame", "generate_sequence"]
