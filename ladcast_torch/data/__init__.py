"""Training data: windowed AR latent datasets and calendar helpers."""
