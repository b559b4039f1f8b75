"""Host-side quaternion helpers, shared with the JAX package.

`vision_slam_frontend_tpu.utils.np_geom` is pure numpy and loads no JAX, so
the port uses it as it is; this module is the port's one door to it.
Quaternions are [w, x, y, z].
"""

from vision_slam_frontend_tpu.utils.np_geom import (
    quat_angular_distance,
    quat_inverse,
    quat_multiply,
    quat_normalize,
    quat_rotate,
)

__all__ = ["quat_angular_distance", "quat_inverse", "quat_multiply", "quat_normalize", "quat_rotate"]
