"""Export of decoded forecasts."""
