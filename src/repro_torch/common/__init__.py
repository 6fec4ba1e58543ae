"""Shared config, tree helpers and the JAX-to-torch weight bridge."""
