"""Device programs: the placement solve (ops/place.py: a CUDA kernel,
csrc/place.cu, and its plain PyTorch version), the dynamic node scorers
(ops/scores.py) and the kernels' build (ops/build.py)."""
