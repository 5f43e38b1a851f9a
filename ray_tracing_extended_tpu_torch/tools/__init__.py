"""The port's measuring entry points: the two roofline probes, each a
hand-written CUDA kernel with its plain PyTorch version."""
