"""Filter, Score and assignment of the port."""
