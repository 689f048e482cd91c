"""Batched scheduling operators: the auction rounds and the water-fill."""
