"""Rank programs of the port, run under its launcher."""
