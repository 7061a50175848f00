"""parallel of the brickmap port."""
