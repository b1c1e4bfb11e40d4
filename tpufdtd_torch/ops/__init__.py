"""Plain eager step and the hand-written kernels with their wrappers."""
