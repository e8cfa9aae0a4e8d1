"""Checkpoints (interchangeable with glass_tpu) and the step meter."""
