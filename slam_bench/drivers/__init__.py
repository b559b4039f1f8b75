"""One driver per traffic kind: set-up, the measured window, the reference."""
