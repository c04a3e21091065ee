"""Attention strategies and the LM trainer of the port (one device)."""
