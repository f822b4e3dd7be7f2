"""PAB evaluation experiments."""
