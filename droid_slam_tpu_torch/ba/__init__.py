"""Dense bundle adjustment."""
