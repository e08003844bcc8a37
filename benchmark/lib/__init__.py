"""What the harness, the drivers, the reference and the metric readers
share: the cell files, the seeded inputs, the model's leaves, the
statistics and the reading of a profiler trace."""
