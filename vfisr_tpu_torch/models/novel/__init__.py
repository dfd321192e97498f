"""Ported parts of the adaptive pipeline."""
