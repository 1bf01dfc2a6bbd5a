"""Calibrated confidence intervals composed from the shared artifacts."""
