"""The plain reference renderer the benchmark holds the port against:
plain PyTorch and numpy, frozen copies of the port's plain code over an
exhaustive intersection, importing nothing of the port and taking nothing
it made (no BVH, clusters, packed tables or Sobol cache)."""
