"""app of the brickmap port."""
