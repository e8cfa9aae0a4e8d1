"""Checkpoint interchange with glass_tpu."""
