"""Keyframe state and the factor graph."""
