"""Recommender family of the port (HRED-QS so far)."""
