"""The autoregressive ensemble rollout."""
