"""Model layers in PyTorch, parameters in the JAX package's layouts."""
