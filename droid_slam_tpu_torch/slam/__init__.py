"""The tracking pipeline."""
