"""Model contract and the ported models."""
