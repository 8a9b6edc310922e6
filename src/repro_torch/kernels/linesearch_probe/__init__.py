from .ops import linesearch_probe, linesearch_probe2, newton_search
