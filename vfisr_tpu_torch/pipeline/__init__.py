"""Deployment pipelines."""
