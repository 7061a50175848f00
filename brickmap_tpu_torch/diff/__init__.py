"""Differentiable rendering of the brickmap port: dense and sparse compositors, inverse rendering."""
