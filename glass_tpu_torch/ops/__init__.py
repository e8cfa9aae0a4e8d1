"""Graph containers, layouts and the ops of the GLASS forward pass."""
