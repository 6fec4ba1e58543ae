"""Hand-written CUDA kernels of the port (``csrc/*.cu``), their build
(``build``), their plain PyTorch versions (``ref``) and the wrappers the
model calls (``ops``)."""
