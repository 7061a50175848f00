"""kernels of the brickmap port."""
