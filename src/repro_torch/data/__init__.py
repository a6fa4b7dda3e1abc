"""Synthetic workloads (numpy only) and the LM data pipeline."""
