"""The Hopper kernels and their build."""
