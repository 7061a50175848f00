"""render of the brickmap port."""
