"""Feature ops: the CUDA kernels and their plain versions, FAST, BRIEF, matching."""
