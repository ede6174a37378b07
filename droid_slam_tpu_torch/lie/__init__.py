"""Lie groups."""
