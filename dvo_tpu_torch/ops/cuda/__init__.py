"""Hand-written CUDA kernels for Hopper, one module each (``gn``,
``gn_level``, ``epipolar``, ``regularize``, ``framebuild``), built and
loaded by ``_build``."""
