"""Action labels, the state log, frame stores and the device dataset."""
