"""Models of the port (plain ``torch.nn`` modules)."""
