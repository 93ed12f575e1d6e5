"""Plain references the benchmark judges the port against."""
