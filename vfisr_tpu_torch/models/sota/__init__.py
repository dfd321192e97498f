"""Ported state-of-the-art models."""
