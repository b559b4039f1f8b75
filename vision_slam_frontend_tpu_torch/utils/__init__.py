"""Host-side numpy helpers."""
