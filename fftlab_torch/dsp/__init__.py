"""Signal processing on the split-plane transforms."""
