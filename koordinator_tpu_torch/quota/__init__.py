"""Elastic quota of the port: the host tree and its device admission."""
