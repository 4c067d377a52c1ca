"""Validation and benchmark cases."""
