"""Plain-tensor ops and the hand-written kernels (K1 conv3x3, K2 heatmap decode)."""
