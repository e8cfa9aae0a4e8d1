"""Training: the epoch loop, the plateau schedule and the F1 metrics."""
