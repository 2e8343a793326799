"""The plain float64 reference the benchmark holds the outputs against."""
