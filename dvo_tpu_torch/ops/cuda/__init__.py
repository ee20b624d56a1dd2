"""Hand-written CUDA kernels for Hopper, one module each (``gn``,
``epipolar``, ``regularize``, ``framebuild``), built and loaded by
``_build``."""
