from .ops import binary_search, linesearch_probe, linesearch_probe2, newton_search
