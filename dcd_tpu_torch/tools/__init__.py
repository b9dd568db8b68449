"""Command lines of the port."""
