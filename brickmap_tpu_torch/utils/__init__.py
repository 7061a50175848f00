"""utils of the brickmap port."""
