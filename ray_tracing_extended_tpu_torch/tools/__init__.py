"""The port's measuring entry points: the two roofline probes, each a
hand-written CUDA kernel with its plain PyTorch version; ``adaptive_bias``
(the refill estimator's bias, exact against refill); ``scan_ab`` (an A/B
of two trees of the port on one card)."""
