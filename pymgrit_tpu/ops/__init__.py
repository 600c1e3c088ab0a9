"""Numerical kernels used by the model zoo."""
