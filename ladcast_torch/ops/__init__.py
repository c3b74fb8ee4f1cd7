"""Tensor ops of the PyTorch port: norms, RoPE, embeddings, the attention
kernels and their plain versions, pixel (un)shuffle and sphere convs."""
