"""Pose-graph and landmark exports: PLY and a standalone HTML viewer."""
