"""Projective geometry."""
