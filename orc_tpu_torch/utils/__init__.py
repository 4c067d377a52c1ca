"""Settings."""
