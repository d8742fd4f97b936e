"""Generation entry points of the port."""
