from .ops import softmax_weights
