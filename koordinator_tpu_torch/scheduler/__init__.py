"""Host snapshot and the reduced scheduling round of the port."""
