"""Training: the experiment protocol, the epoch loop, the plateau schedule,
the F1 and AUROC metrics, and the SSL link-prediction pretraining with its
TPE search."""
