"""Solvers of the port: runtime, factorized machinery, CF-PCA, DCF-PCA."""
