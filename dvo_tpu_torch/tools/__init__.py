"""Measurement scripts of the port that run on the card and are no part of
its paths."""
