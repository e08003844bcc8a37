"""Core services of the port: cvars, pvars, output streams."""
