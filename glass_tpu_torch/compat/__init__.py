"""Compatibility shims for optional third-party dependencies (optuna)."""
