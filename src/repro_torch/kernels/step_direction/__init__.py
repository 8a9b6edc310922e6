from .ops import step_direction
