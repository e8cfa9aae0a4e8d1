"""Training: the experiment protocol, the epoch loop, the plateau schedule
and the F1 and AUROC metrics."""
