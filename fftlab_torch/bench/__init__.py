"""Measurement helpers (counterpart of fftlab/bench/)."""
