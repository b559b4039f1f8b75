"""SLAMProblem serialization."""
