"""Model families of the port (the dense lm family so far)."""
