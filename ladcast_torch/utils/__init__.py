"""Metric logging, YAML loading and phase timing."""
