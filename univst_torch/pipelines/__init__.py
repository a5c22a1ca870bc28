"""Pipelines."""
