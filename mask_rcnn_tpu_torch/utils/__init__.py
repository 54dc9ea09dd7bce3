"""Host utilities: the parameter bridge and mask pasting."""
