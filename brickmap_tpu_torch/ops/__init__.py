"""ops of the brickmap port."""
