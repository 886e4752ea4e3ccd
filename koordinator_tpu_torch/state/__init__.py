"""Device-resident cluster state of the port."""
