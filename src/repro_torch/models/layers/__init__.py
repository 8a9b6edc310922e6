"""Layers of the port's model plane: norms, rope, mlp, attention."""
