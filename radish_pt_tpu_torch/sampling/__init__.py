"""Samplers: Sobol table, lockstep wavefront sampler, alias tables."""
