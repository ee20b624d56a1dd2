"""The benchmark's plain reference: the visual-odometry step in float32
PyTorch (``dvo``) over its own SE(3) (``lie``).  It imports nothing of the
program under test."""
