"""Host-side SLAM problem containers."""
