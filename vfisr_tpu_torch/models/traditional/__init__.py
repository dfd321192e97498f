"""Traditional (non-learned) baselines."""
