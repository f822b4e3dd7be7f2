"""The five families' inference samples."""
