"""The benchmark of vision_slam_frontend_tpu_torch on the H100 (see run.py)."""
