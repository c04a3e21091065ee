"""Metrics, log lines, devices and integer random keys of the port."""
