"""Datasets, width buckets and synthetic task generators."""
