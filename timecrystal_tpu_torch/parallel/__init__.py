"""Batched disorder ensembles."""
