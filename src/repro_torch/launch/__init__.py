"""Workload resolution and the serving CLI."""
