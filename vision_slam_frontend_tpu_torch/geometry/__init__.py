"""Quaternion and camera-model ops on tensors."""
