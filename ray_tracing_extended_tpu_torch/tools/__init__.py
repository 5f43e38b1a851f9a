"""The port's measuring entry points: the two roofline probes, each a
hand-written CUDA kernel with its plain PyTorch version; ``adaptive_bias``
(the refill estimator's bias, exact against refill); ``profile_mega`` (a
frame split into closest hit, fetch and the rest by the kernel's profiling
instantiations); ``scan_ab`` (an A/B of two trees of the port on one
card)."""
