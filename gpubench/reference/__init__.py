"""The plain reference: exact L2 neighbours and distances, in float64.

It reads only the corpus and queries the harness made, and imports
numpy and torch alone: nothing of gamma_tpu_torch, gamma_tpu or jax.
"""
