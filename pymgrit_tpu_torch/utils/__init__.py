"""Observability: plots."""
