"""Latitude weights of the scores and losses."""
