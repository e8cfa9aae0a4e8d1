"""Datasets: the host-side container and the loaders of the 8 GLASS datasets."""
