"""Layers of the port's model plane: norms, rope, mlp, moe, attention, rglru."""
