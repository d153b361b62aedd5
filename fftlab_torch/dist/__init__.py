"""Multi-transform decompositions (counterpart of fftlab/dist/)."""
