"""GLASS as torch.nn modules and their initializers."""
