"""The Gluon layers the port's models use, as ``torch.nn`` modules."""
