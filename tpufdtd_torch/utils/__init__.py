"""Device peaks, performance models, statistics and CSV output."""
