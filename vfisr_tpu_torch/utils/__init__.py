"""Weights and calibration records."""
