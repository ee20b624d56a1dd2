"""Image and geometry operators (plain PyTorch) and, under ``ops.cuda``,
the hand-written kernels."""
