"""Engine configuration identity."""
