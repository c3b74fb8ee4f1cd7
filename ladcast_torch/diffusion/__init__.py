"""EDM preconditioning, sigma schedules and samplers."""
