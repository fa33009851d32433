"""Covariances, reparameterisation, solver engine and GP workflow."""
