"""The DiT, the DCAE and the import of JAX parameter trees."""
