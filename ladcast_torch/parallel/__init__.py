"""Parallelism on ``torch.distributed``: one process per card."""
