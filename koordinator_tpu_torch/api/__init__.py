"""Resource model of the port (numpy only)."""
