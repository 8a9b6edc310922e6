from .ops import linesearch_probe
