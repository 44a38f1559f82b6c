"""Encoders of the port (the feature-hashing encoder only, so far)."""
