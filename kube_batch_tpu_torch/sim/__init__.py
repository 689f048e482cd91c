"""In-process cluster simulator."""
