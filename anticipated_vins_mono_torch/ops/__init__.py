"""Core math ops of the port: Lie groups, preintegration, factors, window solver, kernels."""
