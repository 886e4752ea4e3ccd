"""Resource model and CRD objects of the port (no tensors)."""
