"""Intersection: BVH leaf order, brute-force oracle, Plücker sweeps."""
