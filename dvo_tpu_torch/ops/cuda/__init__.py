"""Hand-written CUDA kernels for Hopper, one module each (``gn``,
``gn_level``, ``epipolar``, ``regularize``, ``framebuild``, ``pose``),
built and loaded by ``_build``."""
