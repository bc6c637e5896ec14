"""Ported compute kernels and spline math."""
